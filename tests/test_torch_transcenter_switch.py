"""``--transcenter-sampling`` in both entry points (``eval/run.py`` and
``serve/server.py``): the choice reaches the detector's
``TransCenterConfig.sampling`` through ``build_detector`` and
``build_transcenter_detector``, and the default stays ``local``.  The flag
is the port's own: busca_tpu's CLIs have none (its TransCenter takes the
sampling from its config alone)."""

import pytest

from busca_tpu_torch.eval import detector as det_mod
from busca_tpu_torch.eval import run as run_mod
from busca_tpu_torch.serve import server as server_mod


class Built(Exception):
    """Raised in place of building the detector, with what it was given."""

    def __init__(self, config, test_size):
        super().__init__("built")
        self.config, self.test_size = config, test_size


class Recorder:
    def __init__(self, config=None, state_dict=None, test_size=None, **kw):
        raise Built(config, test_size)


ENTRY_POINTS = {
    "eval": lambda extra, tmp: run_mod.main(
        ["--mot-dir", str(tmp), "--detector", "transcenter", "--tracker",
         "transcenter", "--device", "cpu"] + extra),
    "serve": lambda extra, tmp: server_mod.main(
        ["--socket", str(tmp / "s.sock"), "--detector", "transcenter",
         "--tracker", "transcenter", "--device", "cpu"] + extra),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("extra,want", [
    ([], "local"),
    (["--transcenter-sampling", "deformable"], "deformable"),
    (["--transcenter-sampling", "local"], "local"),
], ids=["default", "deformable", "local"])
def test_sampling_reaches_the_detector_config(entry, extra, want,
                                              monkeypatch, tmp_path):
    monkeypatch.setattr(det_mod, "TransCenterDetector", Recorder)
    with pytest.raises(Built) as got:
        ENTRY_POINTS[entry](extra + ["--test-h", "64", "--test-w", "96"],
                            tmp_path)
    assert got.value.config.sampling == want
    assert got.value.test_size == (64, 96)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_unknown_sampling_is_refused(entry, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        ENTRY_POINTS[entry](["--transcenter-sampling", "local_pallas"],
                            tmp_path)
    assert e.value.code == 2
    assert "--transcenter-sampling" in capsys.readouterr().err


def test_build_transcenter_detector_defaults_to_local():
    import inspect

    sig = inspect.signature(det_mod.build_transcenter_detector)
    assert sig.parameters["sampling"].default == "local"
