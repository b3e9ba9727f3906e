"""The port's CenterTrack network (busca_tpu_torch/models/centertrack.py)
against busca_tpu.models.centertrack on the CPU.

Tiny nets (the DLA at levels (1, 1, 1, 2, 2, 1), whose Trees nest as at
DLA-34, and the MobileNetV2 backbone) under each decoder sampling, with
busca_tpu's variables carried across by ``centertrack_state_dict_from_flax``:
the four maps within 1e-4 (they agree to about 5e-7).  The variables are
seeded numpy draws shaped by ``jax.eval_shape``; the offset/mask
convolutions are drawn too (busca_tpu initialises them to zero), so the
DCN samples at fractional offsets of a pixel or more, some outside the map.
busca_tpu runs op by op (its DCN ops are jitted each), which is quicker
here than compiling the whole net.

The published layout: the torch DLASeg of tests/torch_oracles.py loads into
the port with ``strict=True`` and reproduces it within the JAX suite's own
bound (rtol 1e-3, atol 2e-4, tests/test_centertrack_model.py).  bf16 is held
in bf16 ulps of each map's scale, as tests/test_torch_bf16_transcenter.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.models import centertrack as jct
from busca_tpu_torch.eval.detector import build_centertrack_detector
from busca_tpu_torch.models import centertrack as tct
from busca_tpu_torch.models.convert import centertrack_state_dict_from_flax
from test_torch_strongsort import one_torch_thread  # noqa: F401
from torch_oracles import TorchDLASeg, bf16_scale_ulps

TOL = 1e-4
HW = (32, 64)
NESTED = (1, 1, 1, 2, 2, 1)
# bf16 bounds in ulps of each map's scale; measured on these seeds: 2.0
# (deformable), 2.0 (windowed), 4.0 (local, whose nine tap products are
# each rounded to bf16 and summed in bf16, as busca_tpu's)
BF16_ULPS = {"deformable": 3.0, "windowed": 3.0, "local": 6.0}
# the windowed DCN's window in the net tests: busca_tpu traces its shifted
# sums op by op, (2 * window + 2) ** 2 per tap; windows 2 and 3 are held
# per op in tests/test_torch_deform.py
NET_WINDOW = 1


def sampling_kw(sampling):
    kw = dict(sampling=sampling)
    if sampling == "windowed":
        kw["dcn_window"] = NET_WINDOW
    return kw


def random_variables(cfg, seed=0, offset_scale=3.0):
    """Seeded numpy variables of busca_tpu's CenterTrackNet(cfg): kernels
    ~ N(0, 1/fan_in) (the offset/mask kernels times ``offset_scale``), BN
    scales near 1, variances in [0.5, 1.5], biases and means ~ N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    h, w = HW
    x = np.zeros((1, h, w, 3), np.float32)
    hm = np.zeros((1, h, w, 1), np.float32)
    shapes = jax.eval_shape(jct.CenterTrackNet(cfg).init,
                            jax.random.PRNGKey(0), x, x, hm)

    def fill(path, s):
        keys = [str(getattr(p, "key", p)) for p in path]
        leaf = keys[-1]
        if leaf in ("kernel", "weight"):
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.randn(*s.shape) / np.sqrt(fan_in)
            if "conv_offset_mask" in keys:
                v = v * offset_scale
            return v.astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def inputs(seed=1):
    rng = np.random.RandomState(seed)
    h, w = HW
    return (rng.randn(1, h, w, 3).astype(np.float32),
            rng.randn(1, h, w, 3).astype(np.float32),
            rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


def port(cfg, variables):
    model = tct.CenterTrackNet(cfg)
    sd = centertrack_state_dict_from_flax(variables)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    return model.eval()


def run_both(kw, variables, args):
    jcfg = jct.CenterTrackConfig.tiny(**kw)
    want = jct.CenterTrackNet(jcfg).apply(variables, *args)
    model = port(tct.CenterTrackConfig.tiny(**kw), variables)
    with torch.no_grad():
        got = model(*(nchw(a) for a in args))
    assert set(got) == set(want) == set(tct.HEADS)
    return got, want


@pytest.mark.parametrize("sampling", tct.SAMPLINGS)
@pytest.mark.parametrize("backbone", ["dla", "mobilenet"])
def test_tiny_net_matches_jax(one_torch_thread, backbone,  # noqa: F811
                              sampling):
    kw = dict(backbone=backbone, levels=NESTED)
    variables = random_variables(jct.CenterTrackConfig.tiny(**kw))
    got, want = run_both(dict(kw, **sampling_kw(sampling)), variables,
                         inputs())
    for k in want:
        g = got[k].numpy().transpose(0, 2, 3, 1)
        assert g.shape == want[k].shape == (1, HW[0] // 4, HW[1] // 4,
                                            g.shape[-1]), k
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=f"{backbone} "
                                   f"{sampling} {k}")


def test_dcn_offsets_are_exercised():
    """The drawn offset convolutions move the taps by fractions of a pixel
    to several pixels, past the net tests' window: the DCN blocks' offsets
    on the test input."""
    cfg = jct.CenterTrackConfig.tiny(levels=NESTED)
    model = port(tct.CenterTrackConfig.tiny(levels=NESTED),
                 random_variables(cfg))
    seen = []
    for m in model.modules():
        if isinstance(m, tct.DCN):
            m.conv_offset_mask.register_forward_hook(
                lambda m, i, o: seen.append(o[:, :18].flatten()))
    with torch.no_grad():
        model(*(nchw(a) for a in inputs()))
    assert len(seen) == 16
    off = torch.cat(seen)
    frac = off - off.floor()
    assert float(off.abs().max()) > NET_WINDOW + 1
    assert float((off.abs() > NET_WINDOW).float().mean()) > 0.05
    assert float(((frac > 0.05) & (frac < 0.95)).float().mean()) > 0.5


@pytest.mark.parametrize("sampling", tct.SAMPLINGS)
def test_tiny_net_bf16_matches_jax(one_torch_thread, sampling):  # noqa
    """``dtype="bfloat16"``: the same float32 variables, each map within
    ``BF16_ULPS[sampling]`` bf16 ulps of its scale."""
    variables = random_variables(jct.CenterTrackConfig.tiny(levels=NESTED),
                                 seed=3)
    got, want = run_both(dict(levels=NESTED, dtype="bfloat16",
                              **sampling_kw(sampling)), variables, inputs(4))
    for k in want:
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == \
            jnp.bfloat16, k
        ulps, exact = bf16_scale_ulps(
            got[k].float().numpy().transpose(0, 2, 3, 1),
            np.asarray(want[k].astype(jnp.float32)))
        print(f"bf16 {sampling} {k}: {ulps:.2f} ulps of scale, exact "
              f"{exact:.3f}")
        assert ulps <= BF16_ULPS[sampling], (sampling, k)


def oracle_dlaseg(levels=NESTED, channels=(4, 8, 8, 16, 16, 32)):
    """The published torch DLASeg at tiny widths, seeded, with small offset
    convolutions (trained offsets are small; the published init is zero)
    and random BN statistics."""
    torch.manual_seed(0)
    oracle = TorchDLASeg(levels=levels, channels=channels, head_conv=16)
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if "conv_offset_mask" in name:
                p.mul_(0.05)
        for mod in oracle.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    return oracle.eval()


@pytest.mark.parametrize("sampling", ["deformable", "windowed"])
def test_published_dlaseg_loads_strict_and_matches(one_torch_thread,  # noqa
                                                   sampling):
    oracle = oracle_dlaseg()
    model = tct.CenterTrackNet(tct.CenterTrackConfig.tiny(levels=NESTED,
                                                          sampling=sampling))
    model.load_state_dict(oracle.state_dict(), strict=True)
    assert list(model.state_dict()) == list(oracle.state_dict())
    model.eval()
    args = [nchw(a) for a in inputs(2)]
    with torch.no_grad():
        want = oracle(*args)
        got = model(*args)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-3, atol=2e-4, err_msg=k)


def test_published_pth_through_build_centertrack_detector(tmp_path):
    """A published-layout ``{epoch, state_dict}`` .pth loads through
    ``build_centertrack_detector``; ``sampling="local"`` refuses it."""
    oracle = oracle_dlaseg(levels=(1, 1, 1, 1, 1, 1))
    pth = str(tmp_path / "ct.pth")
    torch.save({"epoch": 3, "state_dict": oracle.state_dict()}, pth)
    det = build_centertrack_detector("tiny", "deformable", pth,
                                     test_size=HW, device="cpu")
    for k, v in oracle.state_dict().items():
        assert torch.equal(det.model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="free-form DCN offsets"):
        build_centertrack_detector("tiny", "local", pth, device="cpu")


def test_dla34_layout_and_dcn_count():
    """The full-width config builds the published DLA-34 layout: 16 DCN
    blocks (12 in dla_up, 4 in ida_up), published key names."""
    model = tct.CenterTrackNet(tct.CenterTrackConfig())
    dcn = [n for n, m in model.named_modules() if isinstance(m, tct.DCN)]
    assert len(dcn) == 16
    assert sum(n.startswith("dla_up.") for n in dcn) == 12
    oracle = TorchDLASeg()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in oracle.state_dict().items()}
