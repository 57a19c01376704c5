"""PyTorch port: imports neither jax nor ecckd_tpu, and runs without them.

A subprocess with ``sys.modules["jax"] = None`` (and the same for
``ecckd_tpu``), so any import of either raises, imports every module of
``ecckd_tpu_torch`` and runs the merged slice on the CPU end to end.
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
from ecckd_tpu_torch import load_ckd_model, lw_sw_fluxes
from ecckd_tpu_torch.io.synthetic import example_flux_batch, write_synthetic_ckd
with tempfile.TemporaryDirectory() as d:
    for kind in ("lw_fsck", "sw_wide"):
        write_synthetic_ckd(os.path.join(d, kind + ".nc"), kind)
    lw = load_ckd_model(os.path.join(d, "lw_fsck.nc"))
    sw = load_ckd_model(os.path.join(d, "sw_wide.nc"))
b = example_flux_batch(5, 7, np.float32)
T = lambda k: torch.as_tensor(b[k])
out = lw_sw_fluxes(lw, sw, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                   T("emis"), b["concs"], T("alb"), T("tsi"), T("sza"))
for f in out:
    assert f.flux_up.shape == (5, 8) and torch.isfinite(f.flux_up).all()
    assert torch.isfinite(f.flux_dn).all()
print("modules", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
