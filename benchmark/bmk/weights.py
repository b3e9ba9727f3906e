"""The cell's weights, made on the device from ``--seed``.

Each model is built from the benchmark's reference copy on the device and
filled from one ``torch.Generator`` on the device in one draw: a normal
variate per element, scaled by ``1/sqrt(fan_in)`` for matrices and
convolutions (lecun normal), unit norm scales, zero biases and running
means, unit running variances, N(0, 1) special tokens and a detector's
objectness and class prior.  The state dicts are what both the program and
the reference load: the program never makes weights of its own here.  The
detector's and the extractor's models are drawn by their parts
(``bmk/parts``), BUSCA's here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIOR_PROB = 0.01


def torch_seed(seed: int, key: int) -> int:
    """A 63-bit generator seed for one model of one run."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), 7, key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int, key: int,
          prior_on: tuple = ()) -> torch.nn.Module:
    """Fill every parameter and buffer of ``module`` (on its device) from
    one draw of a device generator; the vectors whose names start with one
    of ``prior_on`` take the detection prior's bias."""
    params = list(module.named_parameters())
    device = params[0][1].device
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, key))
    total = sum(p.numel() for _, p in params)
    noise = torch.randn(total, generator=gen, device=device)
    prior = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)
    off = 0
    for name, p in params:
        n = p.numel()
        z = noise[off:off + n].view(p.shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("_token"):
            p.copy_(z)
        elif p.dim() >= 2:
            fan_in = int(np.prod(p.shape[1:]))
            p.copy_(z / math.sqrt(fan_in))
        elif prior_on and name.startswith(prior_on):
            p.fill_(prior)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in module.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("running_mean"):
            b.zero_()
    return module


def busca_model(busca: dict, seed: int, device):
    """The reference BUSCA model of the configuration, filled, in its
    compute dtype (parameters float32, as the program holds them)."""
    from benchref.busca import BuscaConfig, BuscaModel

    cfg = busca_config(busca)
    with torch.device(device):
        model = BuscaModel(cfg)
    return fill_(model, seed, 2).eval()


BUSCA_KEYS = ("num_layer", "nhead", "dim_embedding", "trans_dim", "ff_size",
              "activation", "dropout_p", "input_flavour", "output_flavour",
              "encode_separator_as_reference", "encode_special_tokens",
              "reid_num_classes", "reid_layers", "reid_use_batch_stats",
              "quantize_pe_fp16", "dtype")


def busca_config(busca: dict):
    """The reference ``BuscaConfig`` of the configuration's ``busca``
    group (every field stated in the file)."""
    from benchref.busca import BuscaConfig

    kw = {k: busca[k] for k in BUSCA_KEYS}
    kw["reid_layers"] = tuple(kw["reid_layers"])
    return BuscaConfig(**kw)


def cpu_state(model: torch.nn.Module) -> dict:
    """A host copy of a model's state dict, the form handed to the program
    and kept for the reference after the window."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
