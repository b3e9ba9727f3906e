"""Even-stride file sampler (the reference tools/sample_files.py:1-30; a
copy of ``busca_tpu.utils.sample_files``).

    python -m busca_tpu_torch.utils.sample_files DIR [--num-files K]

prints a comma-separated list of files from a directory — all of them, or
``--num-files`` evenly spaced over the sorted listing (the same
``i * (N-1)/(k-1)`` stride the broader-memory sampler uses).  The reference
uses it to hand a sparse frame subset to demo scripts.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def sample_files(path: str, num_files: Optional[int] = None) -> List[str]:
    if path is None or not os.path.isdir(path):
        raise ValueError(f"Invalid path {path}.")
    total = [
        os.path.join(path, f)
        for f in sorted(os.listdir(path))
        if os.path.isfile(os.path.join(path, f))
    ]
    if num_files is None:
        return total
    if num_files > len(total) or num_files <= 0:
        raise ValueError(f"Invalid number of files {num_files}")
    if num_files == 1:
        return [total[0]]
    stride = (len(total) - 1) / (num_files - 1)
    return [total[int(i * stride)] for i in range(num_files)]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Returns comma-separated list of some files in a folder"
    )
    parser.add_argument("path", type=str, help="dataset folder")
    parser.add_argument("--num-files", type=int, default=None,
                        help="number of files to retrieve")
    args = parser.parse_args(argv)
    print(",".join(sample_files(args.path, args.num_files)))


if __name__ == "__main__":
    main()
