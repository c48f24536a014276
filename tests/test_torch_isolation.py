"""The port stands alone and never hides the device or the kernel.

* Importing fmcw_tpu_torch and every submodule loads neither jax nor
  fmcw_tpu; chip_smoke.py and kernel_ab.py import neither.
* Entry points run on CUDA unless the caller asks for the CPU: without a
  card, make_processor() and the tracker's init_state() /
  state_from_numpy() raise instead of carrying on on the CPU; so do the
  sharded processor's make_mesh(), LocalMesh() and make_sharded_processor()
  (NCCL on CUDA by default, never a quiet fall back to gloo).
* A kernel wrapper takes its plain twin only for a CPU tensor; for a CUDA
  tensor it launches the kernel (checked here with a stand-in library, as
  there is no card) and raises when the launch fails — no fallback.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fmcw_tpu_torch
from fmcw_tpu_torch import kernels
from fmcw_tpu_torch.models import pipeline as tpl, tracker as ttrk
from fmcw_tpu_torch.ops import beam_group as BG, cfar3d_detect as C3
from fmcw_tpu_torch.ops import cfar_detect as CD, cfar_rank as RK
from fmcw_tpu_torch.ops import frontend as F
from fmcw_tpu_torch.ops import frontend_fixed as FX
from fmcw_tpu_torch.ops import split_frontend as SF
from fmcw_tpu_torch.parallel import mesh as PM, sharded as PS

# Share the CPU with the other test workers (the suite runs 6 at once).
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _submodules():
    names = ["fmcw_tpu_torch"]
    for info in pkgutil.walk_packages(fmcw_tpu_torch.__path__,
                                      "fmcw_tpu_torch."):
        names.append(info.name)
    return names


def test_import_loads_neither_jax_nor_fmcw_tpu():
    names = _submodules()
    assert {"fmcw_tpu_torch.ops.frontend", "fmcw_tpu_torch.ops.frontend_fixed",
            "fmcw_tpu_torch.ops.cfar_detect", "fmcw_tpu_torch.ops.notch",
            "fmcw_tpu_torch.ops.beamform", "fmcw_tpu_torch.ops.cfar3d_detect",
            "fmcw_tpu_torch.ops.beam_group", "fmcw_tpu_torch.device",
            "fmcw_tpu_torch.ops.split_frontend",
            "fmcw_tpu_torch.ops.cfar_rank",
            "fmcw_tpu_torch.parallel.mesh", "fmcw_tpu_torch.parallel.sharded",
            "fmcw_tpu_torch.models.scenario", "fmcw_tpu_torch.utils.io",
            "fmcw_tpu_torch.utils.checkpoint",
            "fmcw_tpu_torch.runtime.surveillance",
            "fmcw_tpu_torch.runtime.stream",
            "fmcw_tpu_torch.runtime.native"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'fmcw_tpu'))\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("path", ["chip_smoke.py", "kernel_ab.py",
                                  "fmcw_tpu_torch"])
def test_sources_import_neither_jax_nor_fmcw_tpu(path):
    files = ([ROOT / path] if path.endswith(".py")
             else sorted((ROOT / path).rglob("*.py")))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "fmcw_tpu"), \
                    f"{f.name} imports {m}"


def test_processor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_processor()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_batch_processor(fmcw_tpu_torch.quick(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_array_processor()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_batch_array_processor(fmcw_tpu_torch.quick(), ref_angle=1)
    proc = tpl.make_array_processor(fmcw_tpu_torch.quick(), device="cpu")
    assert proc.route == "fused"


def test_sharded_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """No card: the mesh and the sharded processor raise for device=None
    (before any process group is looked for), whatever the environment
    says; the CPU has to be asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.make_sharded_processor()
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.make_sharded_processor(params=fmcw_tpu_torch.quick(),
                                  device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.LocalMesh(1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.make_sharded_array_processor()
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.make_sharded_array_processor(params=fmcw_tpu_torch.quick(),
                                        ref_angle=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_batch_processor(fmcw_tpu_torch.quick(), include_debug=True)
    assert not torch.distributed.is_initialized()
    mesh = PM.LocalMesh(1, 2, "cpu")
    assert mesh.device.type == "cpu"
    proc = PS.make_sharded_processor(mesh, fmcw_tpu_torch.quick())
    assert proc.route == "fused"
    proc = PS.make_sharded_array_processor(mesh, fmcw_tpu_torch.quick())
    assert proc.route == "fused"


def test_make_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        PM.make_mesh(device="cpu")
    assert PM.mesh_shape(8) == (1, 8)
    assert PM.mesh_shape(8, dp=2) == (2, 4)
    assert PM.mesh_shape(8, sp=2) == (4, 2)
    with pytest.raises(ValueError):
        PM.mesh_shape(8, 3, 2)


def test_tracker_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrk.init_state()
    state = ttrk.init_state(device="cpu")
    assert all(v.device.type == "cpu" for v in state.values())
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrk.state_from_numpy(ttrk.state_to_numpy(state))
    again = ttrk.state_from_numpy(ttrk.state_to_numpy(state), device="cpu")
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_runtime_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """run_scans with no state, the streams and run_surveillance put their
    work on CUDA unless asked for the CPU."""
    from fmcw_tpu_torch.runtime import stream as RS, surveillance as SV
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dets = (np.zeros((2, 4), np.int32),) * 3 + (np.zeros((2, 4), bool),)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrk.run_scans(*dets)
    state, _ = ttrk.run_scans(*dets, device="cpu")
    assert state["active"].device.type == "cpu"
    frames = [np.zeros((2, 2), np.int16)]
    with pytest.raises(RuntimeError, match="CUDA"):
        next(RS.stream(lambda x: {}, frames))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(RS.stream_batched(lambda x: {}, frames, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(SV.run_surveillance(lambda x, **k: {}, frames,
                                 fmcw_tpu_torch.quick()))
    assert len(list(RS.stream(lambda x: {}, frames, device="cpu"))) == 1


def test_chip_smoke_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_ab_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "kernel_ab.py", "--root", "."],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0
    assert '"ms"' not in res.stdout


def _iq(p, batch=1):
    from fmcw_tpu_torch.golden import reference
    frame = tpl.complex_to_iq(reference.two_target_frame(p))
    return torch.as_tensor(np.stack([frame] * batch))


def test_wrappers_take_plain_twin_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch")
    monkeypatch.setattr(kernels, "load", no_build)
    p = fmcw_tpu_torch.quick()
    F.reset_launch_counts()
    iq = _iq(p, 2)
    re, im = F.range_fft(iq)
    pre, pim = F.range_fft_plain(iq)
    assert torch.equal(re, pre) and torch.equal(im, pim)
    out = F.slowtime_detect(re, im, cfar=p.cfar, peak_group_radius=1)
    plain = F.slowtime_detect_plain(re, im, cfar=p.cfar, peak_group_radius=1)
    for a, b in zip(out, plain):
        assert (a is None and b is None) or torch.equal(a, b)
    assert F.range_fft.launches == 0 and F.slowtime_detect.launches == 0
    mag = torch.as_tensor(np.random.default_rng(1).integers(
        0, 3000, (2, p.n_range, p.n_doppler)), dtype=torch.int32)
    for a, b in zip(CD.cfar_detect_group(mag, 3, cfar=p.cfar,
                                         peak_group_radius=2),
                    CD.cfar_detect_group_plain(mag, 3, cfar=p.cfar,
                                               peak_group_radius=2)):
        assert torch.equal(a, b)
    assert CD.cfar_detect_group.launches == 0


class _FakeLib:
    """Stands in for the built library: records launches, returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def fmcw_range_fft(self, *args):
        self.calls.append(("range_fft", args))
        return self.err

    def fmcw_slowtime_detect(self, *args):
        self.calls.append(("slowtime_detect", args))
        return self.err

    def fmcw_range_fft_fixed(self, *args):
        self.calls.append(("range_fft_fixed", args))
        return self.err

    def fmcw_slowtime_detect_fixed(self, *args):
        self.calls.append(("slowtime_detect_fixed", args))
        return self.err

    def fmcw_cfar_detect(self, *args):
        self.calls.append(("cfar_detect", args))
        return self.err

    def fmcw_cfar_detect_group(self, *args):
        self.calls.append(("cfar_detect_group", args))
        return self.err

    def fmcw_cfar_detect_flat(self, *args):
        self.calls.append(("cfar_detect_flat", args))
        return self.err

    def fmcw_range_fft_float(self, *args):
        self.calls.append(("range_fft_float", args))
        return self.err

    def fmcw_slowtime_mag(self, *args):
        self.calls.append(("slowtime_mag", args))
        return self.err

    def fmcw_cfar_3d_detect(self, *args):
        self.calls.append(("cfar_3d_detect", args))
        return self.err

    def fmcw_beam_group(self, *args):
        self.calls.append(("beam_group", args))
        return self.err

    def fmcw_slowtime_detect_split(self, *args):
        self.calls.append(("slowtime_detect_split", args))
        return self.err

    def fmcw_slowtime_detect_fixed_split(self, *args):
        self.calls.append(("slowtime_detect_fixed_split", args))
        return self.err

    def fmcw_cfar_rank(self, *args):
        self.calls.append(("cfar_rank", args))
        return self.err

    def fmcw_cfar_rank_smem(self, cfg):
        return 0


class _Stream:
    cuda_stream = 0


@pytest.fixture
def as_if_cuda(monkeypatch):
    """Route CPU tensors down the wrappers' CUDA branch with a stand-in
    library; the plain twins must then not run."""
    def forbidden(*a, **k):
        raise AssertionError("plain twin called for a CUDA tensor")
    monkeypatch.setattr(F, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(F, "range_fft_plain", forbidden)
    monkeypatch.setattr(F, "slowtime_detect_plain", forbidden)
    monkeypatch.setattr(FX, "range_fft_fixed_plain", forbidden)
    monkeypatch.setattr(FX, "slowtime_detect_fixed_plain", forbidden)
    monkeypatch.setattr(CD, "cfar_detect_plain", forbidden)
    monkeypatch.setattr(CD, "cfar_detect_group_plain", forbidden)
    monkeypatch.setattr(CD.C, "hw_stream_decide_plain", forbidden)
    monkeypatch.setattr(F, "range_fft_float_plain", forbidden)
    monkeypatch.setattr(F, "slowtime_mag_plain", forbidden)
    monkeypatch.setattr(C3, "cfar3d_detect_plain", forbidden)
    monkeypatch.setattr(BG, "beam_group_plain", forbidden)
    monkeypatch.setattr(SF, "slowtime_detect_split_plain", forbidden)
    monkeypatch.setattr(SF, "slowtime_detect_fixed_split_plain", forbidden)
    monkeypatch.setattr(RK, "cfar_rank_plain", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    F.reset_launch_counts()
    return lib


def test_wrappers_launch_kernels_for_cuda_tensors(as_if_cuda):
    p = fmcw_tpu_torch.RadarParams()
    iq = _iq(fmcw_tpu_torch.RadarParams(), 2)
    re, im = F.range_fft(iq)
    assert tuple(re.shape) == (2, p.n_range, p.n_doppler)
    det, mag, row_max, n_dets, nf = F.slowtime_detect(
        re, im, False, 4, cfar=p.cfar, peak_group_radius=2, emit_mag=True)
    assert [c[0] for c in as_if_cuda.calls] == ["range_fft",
                                                "slowtime_detect"]
    assert F.range_fft.launches == 1 and F.slowtime_detect.launches == 1
    assert tuple(det.shape) == tuple(mag.shape) == (2, 1024, 128)
    cfg = as_if_cuda.calls[1][1][9]._obj            # the byref'd config
    assert (cfg.R, cfg.ND, cfg.T, cfg.H, cfg.so, cfg.pgr, cfg.block_mode) == \
        (1024, 128, F.TILE_ROWS, 8, 4, 2, 0)
    fast = fmcw_tpu_torch.fast()
    F.slowtime_detect(re, im, cfar=fast.cfar, peak_group_radius=2)
    cfg = as_if_cuda.calls[2][1][9]._obj
    assert (cfg.H, cfg.block_mode, cfg.sb, cfg.n_blk, cfg.k_blk) == \
        (24, 1, 8, 576, 144)
    # The staged routes' CFAR step: the grouping entry, with the row maxima
    # and counts for the top-K; an int32 map within float_max counts in
    # float.
    mag = torch.zeros((2, p.n_range, p.n_doppler), dtype=torch.int32)
    det, scale, row_max, n_dets = CD.cfar_detect_group(
        mag, 4, cfar=p.cfar, peak_group_radius=2)
    assert as_if_cuda.calls[-1][0] == "cfar_detect_group"
    args = as_if_cuda.calls[-1][1]
    assert args[1] is None and args[4] is not None and args[5] is not None
    cfg = args[6]._obj
    assert (cfg.R, cfg.D, cfg.T, cfg.strip, cfg.packed, cfg.pgr, cfg.so,
            cfg.integer, cfg.prepadded, cfg.float_max) == \
        (1024, 128, 28, 8, 1, 2, 4, 1, 0, (1 << 24) // 13)
    assert det.dtype == row_max.dtype == torch.int32
    assert tuple(row_max.shape) == (2, 1024) and tuple(n_dets.shape) == (2,)
    assert CD.cfar_detect_group.launches == 1 and CD.cfar_detect.launches == 0


def test_failed_launch_raises(as_if_cuda):
    as_if_cuda.err = 1
    with pytest.raises(RuntimeError, match="CUDA error"):
        F.range_fft(_iq(fmcw_tpu_torch.quick()))
    assert F.range_fft.launches == 0


def test_kernel_rejects_unported_configs(as_if_cuda):
    p = fmcw_tpu_torch.quick()
    re = torch.zeros((1, p.n_range, p.n_doppler))
    ca = fmcw_tpu_torch.CfarParams(variant="ca")
    with pytest.raises(NotImplementedError):
        F.slowtime_detect(re, re, cfar=ca)
    long_cpi = torch.zeros((1, 128, 256))
    with pytest.raises(NotImplementedError):
        F.slowtime_detect(long_cpi, long_cpi, cfar=p.cfar)
    assert as_if_cuda.calls == []


def test_fixed_wrappers_take_plain_twin_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch")
    monkeypatch.setattr(kernels, "load", no_build)
    p = fmcw_tpu_torch.quick()
    kernels.reset_launch_counts()
    iq = _iq(p, 2)
    out = FX.range_fft_fixed(iq)
    for a, b in zip(out, FX.range_fft_fixed_plain(iq)):
        assert torch.equal(a, b)
    re, im, _ = out
    out = FX.slowtime_detect_fixed(re, im, cfar=p.cfar, peak_group_radius=1)
    plain = FX.slowtime_detect_fixed_plain(re, im, cfar=p.cfar,
                                           peak_group_radius=1)
    for a, b in zip(out, plain):
        assert (a is None and b is None) or torch.equal(a, b)
    mag = torch.as_tensor(np.random.default_rng(0).integers(
        0, 3000, (2, p.n_range, p.n_doppler)), dtype=torch.int32)
    for a, b in zip(CD.cfar_detect(mag, cfar=p.cfar),
                    CD.cfar_detect_plain(mag, cfar=p.cfar)):
        assert torch.equal(a, b)
    assert set(kernels.launch_counts().values()) == {0}


def test_fixed_wrappers_launch_kernels_for_cuda_tensors(as_if_cuda):
    p = fmcw_tpu_torch.RadarParams()
    iq = _iq(p, 2)
    re, im, sat = FX.range_fft_fixed(iq, rounding="biased")
    assert re.dtype == im.dtype == torch.int16
    assert tuple(re.shape) == (2, p.n_range, p.n_doppler)
    args = as_if_cuda.calls[0][1]
    assert args[6:11] == (2, p.n_doppler, p.n_range, 1 << 14, 14)
    det, mag, row_max, n_dets, sat_d = FX.slowtime_detect_fixed(
        re, im, True, 4, cfar=p.cfar, notch_mode=3, transient="passthrough",
        peak_group_radius=2, emit_mag=True)
    assert det.dtype == mag.dtype == torch.int32
    cfg = as_if_cuda.calls[1][1][9]._obj
    assert (cfg.R, cfg.ND, cfg.so, cfg.pgr, cfg.notch_mode,
            cfg.transient_zero, cfg.bypass, cfg.rnd, cfg.shift) == \
        (1024, 128, 4, 2, 3, 0, 1, 1 << 13, 14)
    fast = fmcw_tpu_torch.fast()
    for cfar, block in ((p.cfar, 0), (fast.cfar, 1)):
        d, scale = CD.cfar_detect(det, 3, cfar=cfar)
        assert d.dtype == torch.int32 and scale.dtype == torch.int32
        cfg = as_if_cuda.calls[-1][1][4]._obj
        assert (cfg.R, cfg.D, cfg.block_mode, cfg.so, cfg.integer) == \
            (1024, 128, block, 3, 1)
        assert (as_if_cuda.calls[-1][1][1] is not None) == bool(block)
    CD.cfar_detect(det.float(), cfar=p.cfar)
    assert as_if_cuda.calls[-1][1][4]._obj.integer == 0
    assert [c[0] for c in as_if_cuda.calls] == [
        "range_fft_fixed", "slowtime_detect_fixed"] + ["cfar_detect"] * 3
    assert (FX.range_fft_fixed.launches, FX.slowtime_detect_fixed.launches,
            CD.cfar_detect.launches) == (1, 1, 3)


def test_fixed_failed_launch_raises(as_if_cuda):
    as_if_cuda.err = 1
    p = fmcw_tpu_torch.quick()
    with pytest.raises(RuntimeError, match="CUDA error"):
        FX.range_fft_fixed(_iq(p))
    mag = torch.zeros((1, p.n_range, p.n_doppler), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        CD.cfar_detect(mag, cfar=p.cfar)
    assert FX.range_fft_fixed.launches == 0 and CD.cfar_detect.launches == 0


def _planes(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(0, 100, shape).astype(np.float32)),
            torch.as_tensor(rng.normal(0, 100, shape).astype(np.float32)))


def test_array_wrappers_take_plain_twin_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch")
    monkeypatch.setattr(kernels, "load", no_build)
    p = fmcw_tpu_torch.quick()
    kernels.reset_launch_counts()
    br, bi = _planes((4, p.n_doppler, p.n_range))
    re, im = F.range_fft_float(br, bi)
    for a, b in zip((re, im), F.range_fft_float_plain(br, bi)):
        assert torch.equal(a, b)
    mag, nf = F.slowtime_mag(re, im, True)
    assert torch.equal(mag, F.slowtime_mag_plain(re, im, True))
    assert nf.tolist() == [0] * 4
    cube = mag.reshape(1, 4, p.n_range, p.n_doppler)
    for a, b in zip(C3.cfar3d_detect(cube, 4, cfar=p.cfar, ref_angle=1),
                    C3.cfar3d_detect_plain(cube, 4, cfar=p.cfar,
                                           ref_angle=1)):
        assert torch.equal(a, b)
    det = torch.where(mag > mag.mean(), mag, 0).reshape(cube.shape)
    for a, b in zip(BG.beam_group(det, 2), BG.beam_group_plain(det, 2)):
        assert torch.equal(a, b)
    assert set(kernels.launch_counts().values()) == {0}


def test_array_wrappers_launch_kernels_for_cuda_tensors(as_if_cuda):
    p = fmcw_tpu_torch.RadarParams()
    br, bi = _planes((2, p.n_doppler, p.n_range))
    re, im = F.range_fft_float(br, bi)
    assert tuple(re.shape) == (2, p.n_range, p.n_doppler)
    args = as_if_cuda.calls[0][1]
    assert args[6:9] == (2, p.n_doppler, p.n_range)
    mag, nf = F.slowtime_mag(re, im, True, exact_mag=True)
    assert tuple(mag.shape) == (2, p.n_range, p.n_doppler)
    cfg = as_if_cuda.calls[1][1][6]._obj
    assert (cfg.batch, cfg.R, cfg.ND, cfg.exact_mag, cfg.notch_mode,
            cfg.transient_zero, cfg.bypass) == (2, 1024, 128, 1, 2, 1, 1)
    cube = torch.zeros((2, 8, p.n_range, p.n_doppler))
    det, scale = C3.cfar3d_detect(cube, 4, cfar=p.cfar, ref_angle=1)
    assert det.dtype == torch.float32 and scale.dtype == torch.int32
    cfg = as_if_cuda.calls[2][1][3]._obj
    assert (cfg.batch, cfg.A, cfg.R, cfg.D, cfg.ha, cfg.ga, cfg.n_ref,
            cfg.k, cfg.so, cfg.integer) == (2, 8, 1024, 128, 1, 0, 414,
                                            104, 4, 0)
    assert cfg.R % cfg.T == 0
    C3.cfar3d_detect(cube.int(), cfar=fmcw_tpu_torch.quick().cfar,
                     ref_angle=2, guard_angle=1)
    cfg = as_if_cuda.calls[3][1][3]._obj
    assert (cfg.ha, cfg.ga, cfg.integer) == (3, 1, 1)
    g, rmax, n = BG.beam_group(cube, 2)
    assert tuple(rmax.shape) == (2, 8 * p.n_range) and tuple(n.shape) == (2,)
    cfg = as_if_cuda.calls[4][1][4]._obj
    assert (cfg.batch, cfg.NB, cfg.R, cfg.D, cfg.radius) == \
        (2, 8, 1024, 128, 2)
    assert [c[0] for c in as_if_cuda.calls] == [
        "range_fft_float", "slowtime_mag", "cfar_3d_detect",
        "cfar_3d_detect", "beam_group"]
    assert (F.range_fft_float.launches, F.slowtime_mag.launches,
            C3.cfar3d_detect.launches, BG.beam_group.launches) == (1, 1, 2, 1)


def test_array_failed_launch_raises(as_if_cuda):
    as_if_cuda.err = 1
    p = fmcw_tpu_torch.quick()
    br, bi = _planes((1, p.n_doppler, p.n_range))
    with pytest.raises(RuntimeError, match="CUDA error"):
        F.range_fft_float(br, bi)
    re = torch.zeros((1, p.n_range, p.n_doppler))
    with pytest.raises(RuntimeError, match="CUDA error"):
        F.slowtime_mag(re, re)
    cube = torch.zeros((1, 4, p.n_range, p.n_doppler))
    with pytest.raises(RuntimeError, match="CUDA error"):
        C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        BG.beam_group(cube, 1)
    assert set(kernels.launch_counts().values()) == {0}


def test_array_kernels_reject_unported_configs(as_if_cuda):
    p = fmcw_tpu_torch.quick()
    br, bi = _planes((1, p.n_doppler, 48))
    with pytest.raises(NotImplementedError):
        F.range_fft_float(br, bi)                   # n_range not 2^k
    long_cpi = torch.zeros((1, 128, 256))
    with pytest.raises(NotImplementedError):
        F.slowtime_mag(long_cpi, long_cpi)
    cube = torch.zeros((1, 4, p.n_range, p.n_doppler))
    ca = fmcw_tpu_torch.CfarParams(variant="ca")
    with pytest.raises(NotImplementedError):
        C3.cfar3d_detect(cube, cfar=ca, ref_angle=1)
    with pytest.raises(ValueError):
        C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=0)    # cfar_detect's
    narrow = torch.zeros((1, 4, 64, 3))
    with pytest.raises(NotImplementedError):
        C3.cfar3d_detect(narrow, cfar=p.cfar, ref_angle=1)   # halo >= D
    with pytest.raises(NotImplementedError):
        BG.beam_group(cube.int(), 1)
    assert as_if_cuda.calls == []
    # The array processor's default route keeps to the kernels: on a long
    # CPI kernel A runs, then kernel B (detect or magnitude-only) raises
    # instead of falling back to the plain transforms.
    long_cpi = p.replace(n_doppler=256)
    iq = np.zeros((4, long_cpi.n_doppler, long_cpi.n_range, 2), np.int16)
    for ref_angle in (0, 1):
        proc = tpl.make_array_processor(long_cpi, n_elems=4, n_beams=4,
                                        ref_angle=ref_angle, device="cpu")
        with pytest.raises(NotImplementedError):
            proc(iq)
    assert [c[0] for c in as_if_cuda.calls] == ["range_fft_float"] * 2


def test_split_wrappers_launch_kernels_for_cuda_tensors(as_if_cuda):
    """Rows 3-6: the range kernels on a chirp shard, kernel B's split entries
    on a range shard with its halo rows, each counted by its own wrapper;
    the shard's place in the frame reaches the kernel's config."""
    p = fmcw_tpu_torch.RadarParams()
    iq = _iq(p, 2)[:, 32:64]                         # chirp shard 1 of 4
    re, im = SF.range_frontend(iq)
    assert tuple(re.shape) == (2, p.n_range, 32)
    assert as_if_cuda.calls[0][1][5:8] == (2, 32, p.n_range)
    SF.range_frontend_fixed(iq)
    nrl, h = 256, p.cfar.halo_range + 2
    re = torch.zeros((2, nrl, p.n_doppler))
    halo = (torch.zeros((2, h, p.n_doppler)),) * 2
    det, mag, rmax, n, nf = SF.slowtime_detect_split(
        re, re, halo, halo, False, 4, 512, cfar=p.cfar, n_range_total=1024,
        peak_group_radius=2, emit_mag=True)
    assert tuple(det.shape) == tuple(mag.shape) == (2, nrl, p.n_doppler)
    cfg = as_if_cuda.calls[2][1][13]._obj
    assert (cfg.R, cfg.H, cfg.pgr, cfg.so, cfg.row_off, cfg.r_total,
            cfg.block_mode) == (nrl, h, 2, 4, 512, 1024, 0)
    i16 = re.to(torch.int16)
    SF.slowtime_detect_fixed_split(i16, i16, (i16[:, :h],) * 2,
                                   (i16[:, :h],) * 2, True, 0, 768,
                                   cfar=p.cfar, n_range_total=1024,
                                   peak_group_radius=2)
    cfg = as_if_cuda.calls[3][1][13]._obj
    assert (cfg.row_off, cfg.r_total, cfg.bypass) == (768, 1024, 1)
    assert [c[0] for c in as_if_cuda.calls] == [
        "range_fft", "range_fft_fixed", "slowtime_detect_split",
        "slowtime_detect_fixed_split"]
    counts = kernels.launch_counts()
    assert (counts["range_frontend"], counts["range_frontend_fixed"],
            counts["slowtime_detect_split"],
            counts["slowtime_detect_fixed_split"]) == (1, 1, 1, 1)
    assert counts["range_fft"] == counts["slowtime_detect"] == 0
    # The whole-frame kernel B sets the frame's own place: rows 0..R of R.
    F.slowtime_detect(re, re, cfar=p.cfar, peak_group_radius=2)
    cfg = as_if_cuda.calls[4][1][9]._obj
    assert (cfg.row_off, cfg.r_total) == (0, nrl)
    # The prepadded CFAR entry: R + 2 halo_range rows in, R rows out.
    hr = p.cfar.halo_range
    d, _ = CD.cfar_detect(torch.zeros((2, nrl + 2 * hr, p.n_doppler)),
                          cfar=p.cfar, prepadded_range=True)
    assert tuple(d.shape) == (2, nrl, p.n_doppler)
    cfg = as_if_cuda.calls[5][1][4]._obj
    assert (cfg.R, cfg.prepadded) == (nrl, 1)


def test_split_kernels_reject_unported_configs(as_if_cuda):
    p = fmcw_tpu_torch.RadarParams()
    h = p.cfar.halo_range
    re = torch.zeros((1, 256, p.n_doppler))
    halo = (torch.zeros((1, h, p.n_doppler)),) * 2
    block = fmcw_tpu_torch.fast().cfar
    with pytest.raises(NotImplementedError, match="per-cell"):
        SF.slowtime_detect_split(re, re, halo, halo, cfar=block,
                                 n_range_total=1024)
    with pytest.raises(ValueError, match="scale_map"):
        CD.cfar_detect(torch.zeros((1, 256 + 2 * h, p.n_doppler)),
                       cfar=block, prepadded_range=True)
    assert as_if_cuda.calls == []


def test_rank_and_shard_entries_take_plain_twin_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch")
    monkeypatch.setattr(kernels, "load", no_build)
    p = fmcw_tpu_torch.quick()
    kernels.reset_launch_counts()
    mag = torch.as_tensor(np.random.default_rng(0).exponential(
        100.0, (2, p.n_range, p.n_doppler)).astype(np.float32))
    for bits in (16, None):
        for a, b in zip(RK.cfar_rank(mag, 3, cfar=p.cfar, bits=bits),
                        RK.cfar_rank_plain(mag, 3, cfar=p.cfar, bits=bits)):
            assert torch.equal(a, b)
    cube = mag.reshape(1, 2, p.n_range, p.n_doppler).repeat(1, 3, 1, 1)
    for a, b in zip(C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=1,
                                     prepadded_angle=True),
                    C3.cfar3d_detect_plain(cube, cfar=p.cfar, ref_angle=1,
                                           prepadded_angle=True)):
        assert torch.equal(a, b) and a.shape[1] == 4
    for a, b in zip(BG.beam_group(cube, 1, beam_offset=2, n_beams=8),
                    BG.beam_group_plain(cube, 1, beam_offset=2, n_beams=8)):
        assert torch.equal(a, b)
    assert set(kernels.launch_counts().values()) == {0}


def test_rank_and_shard_entries_launch_kernels_for_cuda_tensors(as_if_cuda):
    """Row 9 and the sharded array model's two entries: each launches its
    kernel with the shard's geometry in the config; the debug-tap processor
    runs kernel A, the magnitude-only kernel and the rank select."""
    p = fmcw_tpu_torch.RadarParams()
    mag = torch.zeros((2, p.n_range, p.n_doppler))
    det, thr, scale = RK.cfar_rank(mag, 4, cfar=p.cfar, bits=16)
    assert det.dtype == thr.dtype == torch.float32
    assert scale.dtype == torch.int32
    cfg = as_if_cuda.calls[-1][1][7]._obj
    assert (cfg.batch, cfg.R, cfg.D, cfg.bits, cfg.so, cfg.integer,
            cfg.block_mode, cfg.prepadded, cfg.n_ref, cfg.k, cfg.pgr) == \
        (2, 1024, 128, 16, 4, 0, 0, 0, 128, 32, -1)
    assert cfg.R % cfg.T == 0 and as_if_cuda.calls[-1][1][1] is None
    assert as_if_cuda.calls[-1][1][5:7] == (None, None)
    hr = p.cfar.halo_range
    shard = torch.zeros((2, 256 + 2 * hr, p.n_doppler), dtype=torch.int32)
    smap = torch.zeros((2, 256, p.n_doppler), dtype=torch.int32)
    d, _, _ = RK.cfar_rank(shard, cfar=fmcw_tpu_torch.fast().cfar,
                           scale_map=smap, prepadded_range=True)
    assert tuple(d.shape) == (2, 256, p.n_doppler) and d.dtype == torch.int32
    cfg = as_if_cuda.calls[-1][1][7]._obj
    assert (cfg.R, cfg.bits, cfg.integer, cfg.block_mode, cfg.prepadded) == \
        (256, 31, 1, 1, 1)
    assert as_if_cuda.calls[-1][1][1] is not None
    cube = torch.zeros((2, 4, p.n_range, p.n_doppler))
    d, s = C3.cfar3d_detect(cube, cfar=p.cfar, ref_angle=1,
                            prepadded_angle=True)
    assert tuple(d.shape) == (2, 2, p.n_range, p.n_doppler)
    cfg = as_if_cuda.calls[-1][1][3]._obj
    assert (cfg.A, cfg.ha, cfg.prepadded) == (2, 1, 1)
    g, rmax, n = BG.beam_group(cube, 1, beam_offset=6, n_beams=8)
    assert tuple(g.shape) == (2, 2, p.n_range, p.n_doppler)
    assert tuple(rmax.shape) == (2, 2 * p.n_range)
    cfg = as_if_cuda.calls[-1][1][4]._obj
    assert (cfg.NB, cfg.radius, cfg.halo, cfg.id0, cfg.n_total) == \
        (2, 1, 1, 5, 8)
    BG.beam_group(cube, 1)
    cfg = as_if_cuda.calls[-1][1][4]._obj
    assert (cfg.NB, cfg.halo, cfg.id0, cfg.n_total) == (4, 0, 0, 4)
    assert [c[0] for c in as_if_cuda.calls] == [
        "cfar_rank", "cfar_rank", "cfar_3d_detect", "beam_group",
        "beam_group"]
    counts = kernels.launch_counts()
    assert (counts["cfar_rank"], counts["cfar3d_detect"],
            counts["beam_group"]) == (2, 1, 2)
    as_if_cuda.calls.clear()
    q = fmcw_tpu_torch.quick()
    kernels.reset_launch_counts()
    tpl.make_batch_processor(q, include_debug=True, peak_group_radius=2,
                             device="cpu")(_iq(q, 2))
    assert [c[0] for c in as_if_cuda.calls] == [
        "range_fft", "slowtime_mag", "cfar_rank"]
    # The debug route groups in the kernel: its grouping entry, with the
    # row maxima and counts handed to the top-K.
    args = as_if_cuda.calls[-1][1]
    assert args[5] is not None and args[6] is not None
    assert args[7]._obj.pgr == 2 and args[7]._obj.prepadded == 0
    counts = kernels.launch_counts()
    assert (counts["cfar_rank"], counts["cfar_rank_group"]) == (0, 1)


def test_rank_failed_launch_raises(as_if_cuda):
    as_if_cuda.err = 1
    p = fmcw_tpu_torch.quick()
    with pytest.raises(RuntimeError, match="CUDA error"):
        RK.cfar_rank(torch.zeros((1, p.n_range, p.n_doppler)), cfar=p.cfar)
    assert RK.cfar_rank.launches == 0


def test_hw_stream_wrapper_takes_plain_twin_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch")
    monkeypatch.setattr(kernels, "load", no_build)
    p = fmcw_tpu_torch.quick()
    kernels.reset_launch_counts()
    mag = torch.as_tensor(np.random.default_rng(2).integers(
        0, 3000, (2, p.n_range, p.n_doppler)), dtype=torch.int32)
    from fmcw_tpu_torch.ops import cfar as C
    for a, b in zip(C.cfar_2d_hw_stream(mag, 3, cfar=p.cfar,
                                        decide=CD.cfar_detect_hw_stream),
                    C.cfar_2d_hw_stream(mag, 3, cfar=p.cfar)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert set(kernels.launch_counts().values()) == {0}


def test_hw_stream_wrapper_launches_kernel_for_cuda_tensors(as_if_cuda):
    """The flat-stream entry gets the batch of ext streams as they are
    (stride S + 3 lag a frame), the crossed window and the framing's start;
    the float hw-stream processors launch it (fused: after kernel A and the
    magnitude-only kernel); a failed launch raises."""
    p = fmcw_tpu_torch.RadarParams()
    from fmcw_tpu_torch.ops import cfar as C
    S, lag = p.n_range * p.n_doppler, 6 * 128 + 6
    mag = torch.zeros((2, p.n_range, p.n_doppler), dtype=torch.int32)
    det, thr, scale = C.cfar_2d_hw_stream(mag, 3, cfar=p.cfar,
                                          decide=CD.cfar_detect_hw_stream)
    assert thr is None and det.dtype == torch.int32
    assert tuple(scale.shape) == (2, p.n_range, p.n_doppler)
    name, args = as_if_cuda.calls[-1]
    cfg = args[3]._obj
    assert name == "cfar_detect_flat"
    assert (cfg.batch, cfg.R, cfg.D, cfg.hr, cfg.hd, cfg.gr, cfg.gd,
            cfg.n_ref, cfg.k, cfg.so, cfg.integer, cfg.flat, cfg.start0,
            cfg.stride, cfg.T, cfg.strip, cfg.packed, cfg.pgr,
            cfg.block_mode, cfg.prepadded) == \
        (2, 1024, 128, 5, 6, 1, 2, 128, 32, 3, 1, 1, 2 * lag, S + 3 * lag,
         32, 8, 1, -1, 0, 0)
    C.cfar_2d_hw_stream(mag[0].float(), cfar=p.cfar, integer=False,
                        streaming=True, decide=CD.cfar_detect_hw_stream)
    cfg = as_if_cuda.calls[-1][1][3]._obj
    assert (cfg.batch, cfg.integer, cfg.start0) == (1, 0, lag)
    assert CD.cfar_detect_hw_stream.launches == 2
    q = fmcw_tpu_torch.quick()
    iq = _iq(q, 2)
    # (The fixed routes' stages are the plain stage code this fixture
    # forbids; their CFAR step is the call above.)
    for mode, route, want in (
            ("float32", "fused", ["range_fft", "slowtime_mag",
                                  "cfar_detect_flat"]),
            ("float32", "staged", ["cfar_detect_flat"])):
        as_if_cuda.calls.clear()
        proc = tpl.make_batch_processor(q, mode=mode, frontend=route,
                                        cfar_geometry="hw_stream",
                                        device="cpu")
        proc(iq)
        _, hist = proc.stream(iq)
        assert tuple(hist.shape) == (2, 2 * (4 * q.n_doppler + 3))
        assert [c[0] for c in as_if_cuda.calls] == want * 2
    with pytest.raises(ValueError, match="hold the windows"):
        CD.cfar_detect_hw_stream(torch.zeros((2, 100), dtype=torch.int32),
                                 1548, 1024, 128, cfar=p.cfar, integer=True)
    as_if_cuda.err = 1
    with pytest.raises(RuntimeError, match="CUDA error"):
        C.cfar_2d_hw_stream(mag, cfar=p.cfar,
                            decide=CD.cfar_detect_hw_stream)
    assert CD.cfar_detect_hw_stream.launches == 6
