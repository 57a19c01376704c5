"""Shared helpers for the PyTorch port's parity tests (not a test module).

The shipped ckd-definition files are not in the repository, so the parity
tests run on synthetic ones (ecckd_tpu_torch.io.synthetic) written into a
temporary directory and loaded with BOTH loaders.  Inputs are made with
numpy from a seed and handed to both packages; JAX runs on the CPU with
x64 (tests/conftest.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_atmosphere
from ecckd_tpu.gases import GasConcs as JaxGasConcs
from ecckd_tpu.models.loader import load_ckd_model as jax_load
from ecckd_tpu_torch.gases import GasConcs as TorchGasConcs
from ecckd_tpu_torch.io.synthetic import write_synthetic_ckd
from ecckd_tpu_torch.models.loader import load_ckd_model as torch_load

# tier-1 runs several pytest workers at once: keep each one's intra-op
# thread pool small.
torch.set_num_threads(2)

# key: (kind, negative_entry, n_pressure).  "sw_p47" sits on a 47-point
# pressure grid, so (lw, sw_p47) is a pair that is not mergeable.
KINDS = {"lw": ("lw_fsck", False, 53), "sw": ("sw_wide", False, 53),
         "lw_neg": ("lw_fsck", True, 53), "sw_neg": ("sw_wide", True, 53),
         "lw_rrtmgp": ("lw_rrtmgp", False, 53),
         "sw_p47": ("sw_wide", False, 47)}
NP = {torch.float32: np.float32, torch.float64: np.float64}


@pytest.fixture(scope="session")
def ckd_paths(tmp_path_factory):
    """Synthetic ckd files (KINDS): lw/sw (all tables >= 0), lw_neg/sw_neg
    (negative entries), lw_rrtmgp (36 g-points in 16 bands) and sw_p47
    (another pressure grid), written once and shared by every test."""
    d = tmp_path_factory.mktemp("ckd")
    paths = {}
    for key, (kind, neg, n_p) in KINDS.items():
        paths[key] = str(d / f"{key}.nc")
        write_synthetic_ckd(paths[key], kind, seed=7, negative_entry=neg,
                            n_pressure=n_p)
    return paths


def load_both(path: str, dtype=torch.float64):
    """(jax_model, torch_model) from one file at one dtype."""
    return (jax_load(path, dtype=NP[dtype]),
            torch_load(path, dtype=dtype))


def atmosphere(ncol: int, nlay: int, seed: int = 0):
    """conftest.make_atmosphere plus the RFMIP well-mixed gases, with
    ch4 below its 1.921e-6 reference mole fraction in one column (the
    relative-linear negative-weight clamp) and h2o over four decades."""
    atm = make_atmosphere(ncol, nlay, seed=seed)
    ch4 = np.full(ncol, 1.83e-6)
    ch4[ncol // 2] = 1.2e-6
    gases = dict(h2o=atm["h2o"], o3=atm["o3"], co2=np.full(ncol, 3.97e-4),
                 ch4=ch4, n2o=np.full(ncol, 3.27e-7), o2=0.2095,
                 cfc11=np.full(ncol, 2.33e-10), cfc12=5.2e-10)
    return atm, gases


def flux_batch(ncol, nlay, seed, dtype):
    """``atmosphere`` as numpy arrays of one dtype, plus surface and sun:
    emissivity and albedo ramps, TSI 1361 W m-2, day, grazing and night
    suns (sza 0..110 deg)."""
    atm, gases = atmosphere(ncol, nlay, seed=seed)
    f = lambda x: np.asarray(x, NP[dtype])
    return dict(
        plev=f(atm["plev"]), tlay=f(atm["tlay"]), tlev=f(atm["tlev"]),
        tsfc=f(atm["tsfc"]), emis=f(np.linspace(0.85, 1.0, ncol)),
        alb=f(np.linspace(0.05, 0.8, ncol)), tsi=f(np.full(ncol, 1361.0)),
        sza=f(np.linspace(0.0, 110.0, ncol)), gases=gases)


def jax_concs(gases: dict, dtype=np.float64) -> JaxGasConcs:
    return JaxGasConcs.create([(k, jnp.asarray(np.asarray(v, dtype)))
                               for k, v in gases.items()])


def torch_concs(gases: dict, dtype=torch.float64,
                device="cpu") -> TorchGasConcs:
    return TorchGasConcs.create([(k, torch.as_tensor(
        np.array(v, NP[dtype]), device=device)) for k, v in gases.items()])


def both(x, dtype=torch.float64):
    """The same numpy array as a JAX and a torch array."""
    x = np.array(x, NP[dtype])
    return jnp.asarray(x), torch.as_tensor(x)
