"""The port's Pd/Pfa CLI (``python -m fmcw_tpu_torch.tools.detection_eval``)
against ``tools/detection_eval.py``: its flags, its JSON outputs' layout,
its artifact spec; on the CPU with ``--cpu``, and it refuses to run on the
CPU without that flag where there is no card."""

import inspect
import json
from pathlib import Path

import pytest
import torch

from fmcw_tpu.utils import eval as jev
from fmcw_tpu_torch.models import pipeline as tpl
from fmcw_tpu_torch.params import CfarParams, RadarParams
from fmcw_tpu_torch.tools import detection_eval as DE
from fmcw_tpu_torch.utils import eval as tev

torch.set_num_threads(2)

EVAL_JSON = Path(__file__).resolve().parent.parent / "EVAL.json"


def _layout(res: dict) -> dict:
    """{variant: sorted pd keys} with every pfa / pd a float."""
    for r in res.values():
        assert set(r) == {"pfa", "pd"} and isinstance(r["pfa"], float)
        assert all(isinstance(v, float) for v in r["pd"].values())
    return {v: sorted(r["pd"]) for v, r in res.items()}


def test_json_output_has_jax_layout(tmp_path):
    out = tmp_path / "pd.json"
    assert DE.main(["--cpu", "--trials", "2", "--variants", "os,ca",
                    "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    snrs = inspect.signature(jev.pd_pfa).parameters["snr_dbs"].default
    assert _layout(res) == {v: sorted(str(s) for s in snrs)
                            for v in ("os", "ca")}
    assert res["os"]["pd"]["-18"] == 1.0
    assert 0.0 <= res["ca"]["pfa"] < 1e-3


def test_artifact_spec_equals_eval_json():
    art = json.loads(EVAL_JSON.read_text())
    assert DE.ARTIFACT_SPEC == art["spec"]
    assert DE.ARTIFACT_SPEC_3D == art["spec_3d"]


def test_artifact_layout_equals_eval_json(tmp_path, monkeypatch):
    """The artifact writer at a cut spec (1 trial a SNR, 2 SNRs) on the CPU
    writes EVAL.json's sections, variants and keys."""
    monkeypatch.setattr(DE, "ARTIFACT_SPEC", dict(
        DE.ARTIFACT_SPEC, trials=1, noise_trials=1, snr_dbs=[-35, -18]))
    monkeypatch.setattr(DE, "ARTIFACT_SPEC_3D", dict(
        DE.ARTIFACT_SPEC_3D, trials=1, noise_trials=1, snr_dbs=[-44, -27]))
    out = tmp_path / "EVAL.json"
    assert DE.main(["--cpu", "--artifact", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads(EVAL_JSON.read_text())
    assert set(got) == set(want)
    assert set(got["results"]) == set(want["results"])
    for sec, res in want["results"].items():
        assert set(got["results"][sec]) == set(res), sec
        assert _layout(got["results"][sec]) == {
            v: ["-18", "-35"] if sec != "angle_ref1" else ["-27", "-44"]
            for v in res}


def test_routes_follow_kernel_b_tile():
    """The sweep's processors take the float "auto" route: kernel B
    ("fused") where its tile takes the configuration; the 256x64 block
    scale at scale_block 2 (more blocks than the tile holds) runs the
    staged route, decided when the processor is built."""
    small = dict(n_range=256, n_doppler=64)
    block2 = CfarParams(scale_mode="block", scale_block=2)
    for p, want in ((RadarParams(**small), "fused"),
                    (RadarParams(**small, cfar=block2), "staged"),
                    (RadarParams(cfar=CfarParams(scale_mode="block")),
                     "fused")):
        assert tpl.resolve_frontend("float32", "auto", p) == want
        assert tpl.make_batch_processor(p, device="cpu").route == want
    # The magnitude-only entry (debug taps) takes the block-2 map.
    assert tpl.make_batch_processor(RadarParams(**small, cfar=block2),
                                    include_debug=True,
                                    device="cpu").route == "fused"


def test_without_cpu_flag_and_card_it_raises(monkeypatch):
    def ran(*a, **k):
        raise AssertionError("the sweep ran")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tev, "pd_pfa", ran)
    monkeypatch.setattr(tev, "pd_pfa_3d", ran)
    for argv in (["--trials", "2"], ["--artifact", "unused.json"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            DE.main(argv)
    assert not Path("unused.json").exists()
