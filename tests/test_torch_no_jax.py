"""PyTorch port: imports neither jax nor ecckd_tpu, and runs without them.

A subprocess with ``sys.modules["jax"] = None`` (and the same for
``ecckd_tpu``), so any import of either raises, imports every module of
``ecckd_tpu_torch`` and runs on the CPU: the merged slice (also through
``utils/capture.jit``), ``lw_fluxes`` and ``sw_fluxes``, the combined
RFMIP driver (``--device cpu``) on a synthetic RFMIP file written by the
port, through the native netCDF3 engine and again with ``--fast`` (the
torch route: the same files), the fast plain version, ``scale_bench``
with ``--out-dir``, the column split over two CPU devices, and the
sharded stream over three (the one-device stream's values); then imports
``bench_cuda``, ``chip_smoke``, ``tools/check_cuda_perf_claims.py`` and
``tools/stream_scaling.py`` and runs ``bench_cuda``'s ``cpu_baseline`` at
4 columns.
"""
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile, os
sys.modules["jax"] = None
sys.modules["ecckd_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(2)
import ecckd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ecckd_tpu_torch.__path__,
                                               "ecckd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "ecckd_tpu."))
               for k, v in sys.modules.items() if v is not None)
from ecckd_tpu_torch import load_ckd_model, lw_fluxes, lw_sw_fluxes, sw_fluxes
from ecckd_tpu_torch.cli import ecckd_rfmip
from ecckd_tpu_torch.io.rfmip import read_fluxes, write_synthetic_rfmip
from ecckd_tpu_torch.io.synthetic import example_flux_batch, write_synthetic_ckd
b = example_flux_batch(5, 7, np.float32)
T = lambda k: torch.as_tensor(b[k])
with tempfile.TemporaryDirectory() as d:
    ckd = {k: os.path.join(d, k + ".nc") for k in ("lw_fsck", "sw_wide")}
    for kind, path in ckd.items():
        write_synthetic_ckd(path, kind)
    lw = load_ckd_model(ckd["lw_fsck"])
    sw = load_ckd_model(ckd["sw_wide"])
    out = lw_sw_fluxes(lw, sw, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                       T("emis"), b["concs"], T("alb"), T("tsi"), T("sza"))
    from ecckd_tpu_torch import capture
    jitted = capture.jit(lw_sw_fluxes)
    for _ in range(3):
        again = jitted(lw, sw, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                       T("emis"), b["concs"], T("alb"), T("tsi"), T("sza"))
        assert all(torch.equal(g.flux_up, e.flux_up)
                   and torch.equal(g.flux_dn, e.flux_dn)
                   for g, e in zip(again, out))
    out += (lw_fluxes(lw, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                      T("emis"), b["concs"], n_gauss_angles=3),
            sw_fluxes(sw, T("plev"), T("tlay"), b["concs"], T("alb"),
                      T("tsi"), T("sza")))
    for f in out:
        assert f.flux_up.shape == (5, 8) and torch.isfinite(f.flux_up).all()
        assert torch.isfinite(f.flux_dn).all()
    rfmip = os.path.join(d, "rfmip.nc")
    write_synthetic_rfmip(rfmip, nsite=3, nlay=6, nexp=2, seed=1)
    assert ecckd_rfmip.main([rfmip, ckd["lw_fsck"], ckd["sw_wide"],
                             "--device", "cpu", "--output-dir", d]) == 0
    rsd = read_fluxes(os.path.join(
        d, "rsd_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"), "rsd")
    assert rsd.shape == (6, 7) and np.isfinite(rsd).all()
    from ecckd_tpu_torch import config
    from ecckd_tpu_torch.io import nc3_native
    from ecckd_tpu_torch.io.rfmip import io_engine
    assert nc3_native.load_library() is not None and io_engine() == "native"
    fast_dir, metrics = os.path.join(d, "fast"), os.path.join(d, "m.json")
    assert ecckd_rfmip.main([rfmip, ckd["lw_fsck"], ckd["sw_wide"],
                             "--device", "cpu", "--output-dir", fast_dir,
                             "--fast", "--metrics-json", metrics]) == 0
    import json
    m = json.load(open(metrics))
    assert (m["io_engine"], m["mxu_precision"]) == ("native", "bf16")
    assert np.array_equal(read_fluxes(os.path.join(
        fast_dir, "rsd_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"), "rsd"), rsd)
    from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_plain
    emis_gpt = T("emis")[:, None].expand(-1, lw.ngpt)
    plain = lambda **kw: lwsw_fluxes_plain(
        lw, sw, T("plev"), T("tlay"), T("tlev"), T("tsfc"), emis_gpt,
        b["concs"], T("alb"), T("tsi"), T("sza"), **kw)
    fast, exact = plain(), plain(mxu_mode="bf16x3")
    assert all(torch.isfinite(f).all() for f in fast)
    assert not torch.equal(fast[0], exact[0])
    config.set_mxu_precision("bf16x3")
    from ecckd_tpu_torch.cli import scale_bench
    from ecckd_tpu_torch.parallel import mesh
    flx = os.path.join(d, "flx")
    assert scale_bench.main(["--device", "cpu", "--columns", "32", "--chunk",
                             "16", "--nlay", "6", "--lw-file", ckd["lw_fsck"],
                             "--sw-file", ckd["sw_wide"], "--out-dir",
                             flx]) == 0
    assert np.isfinite(np.load(os.path.join(flx, "rsu.npy"))).all()
    args = (lw, T("plev"), T("tlay"), T("tlev"), T("tsfc"), T("emis"),
            b["concs"])
    split = mesh.shard_columns_call(lambda m, *a: lw_fluxes(m, *a),
                                    [torch.device("cpu")] * 2, args, 5,
                                    replicated_argnums=(0,))
    assert split.flux_up.shape == (5, 8)
    assert torch.isfinite(split.flux_dn).all()
    from ecckd_tpu_torch.parallel.scale import run_weak_scaling
    from ecckd_tpu_torch.utils import capture
    streams = []
    for cpus in ([torch.device("cpu")], [torch.device("cpu")] * 3):
        seen = []
        run_weak_scaling(
            capture.jit(scale_bench.make_step("full")),
            scale_bench.resident_chunks(lw, sw, b, cpus, 5), 2, 5, mesh=cpus,
            consume=lambda host, i: seen.append([a.copy() for a in host]))
        streams.append(seen)
    # float32 on the CPU: a piece's length can change a vectorised
    # loop's tail, so allow the float32 rounding (test_torch_sharded_stream
    # holds float64 bit for bit).
    assert all(x.shape == y.shape and np.allclose(x, y, rtol=1e-5, atol=0)
               for one, three in zip(*streams) for x, y in zip(one, three))
import bench_cuda
import chip_smoke
from tools import check_cuda_perf_claims, stream_scaling
rec = bench_cuda.run_bench("cpu_baseline", ncol=4, steps=1)
assert rec["value"] > 0 and rec["precision"] == "float64"
assert callable(check_cuda_perf_claims.check)
assert callable(stream_scaling.check) and callable(chip_smoke.kernel_bound)
assert not any(k == "jax" or k.startswith(("jax.", "ecckd_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("modules", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
