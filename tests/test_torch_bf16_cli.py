"""The CLI's compute dtype: with no flag, both packages' ``--use-busca``
engines compute in bfloat16 (busca_tpu's ``--busca-dtype`` default,
busca_tpu/eval/run.py:612-616); ``--busca-dtype float32`` is the parity
mode; ``build_engine(dtype=...)`` overrides the config's, as busca_tpu's
does.  The weights stay float32.
"""

import pytest
import torch

from busca_tpu.eval import run as jrun
from busca_tpu_torch.eval import run as trun
from test_torch_bf16 import BF16
from test_torch_byte_pipeline import SMALL


class _Built(Exception):
    pass


def test_cli_default_dtype_is_bfloat16_in_both_packages(tmp_path,
                                                        monkeypatch):
    """Both CLIs parse their arguments and build the engine with no dtype
    flag: both engines compute in bfloat16 (busca_tpu's
    tests/test_server.py::test_serve_cli_busca_dtype_default_matches_eval
    checks its own two CLIs the same way)."""
    import yaml

    cfg = str(tmp_path / "busca.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"transformer": dict(
            SMALL, reid_layers=list(SMALL["reid_layers"]))}, f)
    built = {}
    for name, mod, extra in (("busca_tpu", jrun, []),
                             ("port", trun, ["--device", "cpu"])):
        real = mod.build_engine

        def spy(*a, _real=real, _name=name, **k):
            built[_name] = _real(*a, **k)[0]
            raise _Built

        monkeypatch.setattr(mod, "build_engine", spy)
        with pytest.raises(_Built):
            mod.main(["--synthetic", "--use-busca", "--busca-config", cfg,
                      "--crop-h", "64", "--crop-w", "32"] + extra)
    assert built["busca_tpu"].config.dtype == BF16
    assert built["port"].config.dtype == BF16
    assert next(built["port"].model.transformer_encoder.parameters()
                ).dtype == torch.float32  # the weights stay float32
    # and the flag picks the parity mode
    def spy_dtype(*a, **k):
        built["flag"] = k["dtype"]
        raise _Built

    monkeypatch.setattr(trun, "build_engine", spy_dtype)
    with pytest.raises(_Built):
        trun.main(["--synthetic", "--use-busca", "--busca-dtype",
                   "float32", "--device", "cpu"])
    assert built["flag"] == "float32"


def test_build_engine_dtype_override():
    eng, _ = trun.build_engine(device="cpu", crop_hw=(64, 32),
                               dtype=BF16, bank_slots=0)
    assert eng.config.dtype == BF16 == eng.model.config.dtype
    assert eng.model.reid_encoder.model.conv1.compute_dtype == torch.bfloat16
    eng, _ = trun.build_engine(device="cpu", crop_hw=(64, 32), bank_slots=0)
    assert eng.config.dtype == "float32"  # BuscaConfig's own default
