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

KINDS = {"lw": ("lw_fsck", False), "sw": ("sw_wide", False),
         "lw_neg": ("lw_fsck", True), "sw_neg": ("sw_wide", True)}
NP = {torch.float32: np.float32, torch.float64: np.float64}


@pytest.fixture(scope="session")
def ckd_paths(tmp_path_factory):
    """Synthetic ckd files: lw/sw (all tables >= 0) and lw_neg/sw_neg
    (negative entries), written once per test session."""
    d = tmp_path_factory.mktemp("ckd")
    paths = {}
    for key, (kind, neg) in KINDS.items():
        paths[key] = str(d / f"{key}.nc")
        write_synthetic_ckd(paths[key], kind, seed=7, negative_entry=neg)
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
