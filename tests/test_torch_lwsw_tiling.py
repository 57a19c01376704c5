"""PyTorch port: the merged kernel's staging plan and argument layout
(ops/cuda/staged.py), and its plain version on columns too deep for shared
memory.

The kernel itself (csrc/lwsw.cu) runs only on a card; these tests hold
what the host decides for it:

* ``stage_plan``: the staging floats per column, C (columns staged per
  block), shared memory or a device slice, threads per block, and where
  the layer parameters go, against counts written out here by hand from
  csrc/common.cuh's row layout;
* the ctypes mirror of ``LwswArgs`` and of the staging plan ``Tile``
  (csrc/staged.cuh): field order as the C source declares it, offsets and
  size by hand;
* ``lwsw_fluxes_plain`` at nlay 300 (the device-staging case) at float64
  against JAX's XLA ``lw_fluxes`` + ``sw_fluxes``: max|d| / flux scale
  <= 1e-7, the bound of tests/test_torch_lwsw.py, so the reference the
  card holds that case against is itself held.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (ckd_paths, flux_batch, jax_concs,  # noqa: F401
                          load_both, torch_concs)
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu_torch.ops.cuda import binding, lwsw, plan, staged

torch.set_num_threads(2)

# The synthetic lw_fsck / lw_rrtmgp and sw_wide models under the RFMIP
# gases: (dense gases, LUT gases) per band.
GASES_LW, GASES_SW = (7, 1), (5, 1)
# Shared memory per block (opt-in) and per SM, in bytes: an H100's.
H100 = (232_448, 233_472)


def by_hand(nlay, ng_lw, ng_sw, n_ang, gases_lw=GASES_LW,
            gases_sw=GASES_SW, limits=H100):
    """(floats per column, C, shared, shared bytes per block, threads,
    parameters in the r_dif row) from csrc/common.cuh's layout."""
    lw_rows = 3 * nlay if n_ang == 1 else 3 * nlay + 1  # tr/src or tau/B
    sw_rows = 5 * nlay + 2        # r_dif, t_dif, r_dir+1, t_dir, t+1
    acc = 2 * (nlay + 1) * (n_ang + 1)  # up, dn per LW angle, then SW
    per_layer = (8 + gases_lw[0] + 3 * gases_lw[1] + gases_sw[0]
                 + 3 * gases_sw[1])        # 4 Planck words with LW
    in_rows = ng_sw <= 32 and per_layer <= ng_sw
    floats = (lw_rows * ng_lw + sw_rows * ng_sw + acc
              + (0 if in_rows else per_layer * nlay))
    fit = limits[0] // (4 * floats)
    if fit == 0:
        return floats, 2, False, 0, 512, in_rows
    c = min(fit, 2)
    smem = c * 4 * floats
    threads = 512 if 2 * (smem + 1024) <= limits[1] else 1024
    return floats, c, True, smem, threads, in_rows


@pytest.mark.parametrize("n_ang", [1, 2, 3, 4])
@pytest.mark.parametrize("ng_lw", [32, 36])
@pytest.mark.parametrize("nlay", [1, 2, 8, 60, 137, 300])
def test_stage_plan_matches_the_count_by_hand(nlay, ng_lw, n_ang):
    p = staged.stage_plan(nlay, ng_lw, 27, n_ang, GASES_LW, GASES_SW, *H100)
    floats, c, shared, smem, threads, in_rows = by_hand(nlay, ng_lw, 27,
                                                        n_ang)
    assert p.col_floats == floats and p.bytes_per_column == 4 * floats
    assert (p.slots, p.shared, p.shared_bytes, p.threads) == (c, shared,
                                                             smem, threads)
    assert (p.prm_floats == 0) == in_rows
    assert p.prm_sw == 8 + GASES_LW[0] + 3 * GASES_LW[1]
    # Layer j's parameters sit in its r_dif row, after the LW rows.
    assert (p.prm_base, p.prm_stride) == (p.lw_floats, 27)


def test_stage_plan_at_the_main_path_and_the_edges():
    """Literal numbers for the cases the card runs (nlay 60: two columns
    of 56,632 B per block, two blocks of 512 threads per SM)."""
    main = staged.stage_plan(60, 32, 27, 1, GASES_LW, GASES_SW, *H100)
    assert (main.lw_floats, main.sw_floats, main.acc_floats) == (5760, 8154,
                                                                 244)
    assert (main.bytes_per_column, main.slots, main.shared_bytes,
            main.threads) == (56632, 2, 113264, 512)
    four = staged.stage_plan(60, 32, 27, 4, GASES_LW, GASES_SW, *H100)
    assert (four.bytes_per_column, four.shared_bytes, four.threads) == (
        58224, 116448, 1024)          # two blocks would need 234,944 B
    rrtmgp = staged.stage_plan(60, 36, 27, 1, GASES_LW, GASES_SW, *H100)
    assert (rrtmgp.bytes_per_column, rrtmgp.slots, rrtmgp.threads) == (
        59512, 2, 1024)
    deep = staged.stage_plan(137, 32, 27, 1, GASES_LW, GASES_SW, *H100)
    assert (deep.bytes_per_column, deep.slots, deep.shared) == (129012, 1,
                                                                True)
    device = staged.stage_plan(300, 32, 27, 1, GASES_LW, GASES_SW, *H100)
    assert (device.bytes_per_column, device.slots, device.shared,
            device.shared_bytes, device.threads) == (282232, 2, False, 0,
                                                     512)


@pytest.mark.parametrize("nlay", [1, 60, 137, 300])
def test_stage_plan_follows_the_cards_shared_memory(nlay):
    """The limits are the card's: on one with 163 KB per block and 164 KB
    per SM (an A100's), nlay 60 keeps C = 2 in one block of 1024 threads
    per SM, and nlay 137 still fits one column."""
    small = (166_912, 167_936)
    p = staged.stage_plan(nlay, 32, 27, 1, GASES_LW, GASES_SW, *small)
    _, c, shared, smem, threads, _ = by_hand(nlay, 32, 27, 1, limits=small)
    assert (p.slots, p.shared, p.shared_bytes, p.threads) == (c, shared,
                                                             smem, threads)
    if nlay == 60:
        assert (p.slots, p.threads) == (2, 1024)
    if nlay == 137:
        assert (p.slots, p.shared) == (1, True)


@pytest.mark.parametrize("ng_sw,gases_lw", [(40, GASES_LW), (27, (14, 1))])
def test_layer_parameters_get_a_place_of_their_own(ng_sw, gases_lw):
    """More SW g-points than one chunk, or more parameters than the r_dif
    row holds: the parameters go after the accumulators."""
    p = staged.stage_plan(60, 32, ng_sw, 1, gases_lw, GASES_SW, *H100)
    per_layer = 8 + gases_lw[0] + 3 * gases_lw[1] + 5 + 3
    assert p.prm_floats == per_layer * 60 and p.prm_stride == per_layer
    assert p.prm_base == p.lw_floats + p.sw_floats + p.acc_floats
    assert p.col_floats == by_hand(60, 32, ng_sw, 1, gases_lw)[0]


def test_band_gases_of_the_synthetic_models(ckd_paths):
    names = ("h2o", "o3", "co2", "ch4", "n2o", "o2", "cfc11", "cfc12")
    for key, want in (("lw", GASES_LW), ("lw_rrtmgp", GASES_LW),
                      ("sw", GASES_SW)):
        _, model = load_both(ckd_paths[key], torch.float32)
        assert staged.band_gases(plan.build_plan(model, names)) == want


def c_fields(struct: str, source: str = "lwsw.cu"):
    """Field names of a struct in csrc/<source>, in declaration order."""
    src = (Path(lwsw.__file__).parents[2] / "csrc" / source).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    body = re.sub(r"//[^\n]*|\[[^\]]*\]", "", body)
    return [n for decl in body.split(";") if decl.strip()
            for n in re.findall(r"(\w+)\s*(?:,|$)", decl.strip())]


def test_args_mirror_the_c_structs():
    tile, args = binding.Tile, binding.LwswArgs
    assert [f for f, _ in tile._fields_] == c_fields("Tile", "staged.cuh")
    assert [f for f, _ in args._fields_] == c_fields("LwswArgs")
    for struct in ("Band", "LwSolve", "SwSolve"):
        assert [f for f, _ in getattr(binding, struct)._fields_] == \
            c_fields(struct, "common.cuh")
    # By hand: a pointer, then eleven ints (padded to 8 bytes); the
    # structs before it as in
    # common.cuh (Atmos 48, Grid 40, Band 728 twice (a pointer, three
    # ints, 16 slices of 44 bytes, padded to 8), LwSolve 96, SwSolve 56
    # bytes).
    assert ctypes.sizeof(tile) == 8 + 11 * 4 + 4
    assert [getattr(tile, f).offset for f, _ in tile._fields_] \
        == [0] + list(range(8, 52, 4))
    sizes = [ctypes.sizeof(t) for t in (binding.Atmos, binding.Grid,
                                        binding.Band, binding.LwSolve,
                                        binding.SwSolve)]
    assert sizes == [48, 40, 728, 96, 56]
    assert args.tile.offset == 48 + 40 + 2 * 728 + 96 + 56
    assert ctypes.sizeof(args) == 1696 + 56


def test_tile_struct_carries_the_plan():
    p = staged.stage_plan(60, 32, 27, 3, GASES_LW, GASES_SW, *H100)
    t = staged.tile_struct(p, blocks=264)
    assert (t.stage, t.slots, t.sets, t.blocks, t.threads,
            t.shared_bytes) == (None, 2, 1, 264, 512, p.shared_bytes)
    assert (t.col_floats, t.lw_floats, t.sw_floats) == (
        p.col_floats, p.lw_floats, p.sw_floats)
    assert (t.prm_base, t.prm_stride, t.prm_sw) == (p.lw_floats, 27, 18)


@pytest.mark.parametrize("n_angles", [1, 3])
def test_plain_f64_at_nlay300_matches_jax_xla(ckd_paths, n_angles):
    jl, tl = load_both(ckd_paths["lw"])
    js, ts = load_both(ckd_paths["sw"])
    b = flux_batch(3, 300, seed=11, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    jc = jax_concs(b["gases"])
    ref_lw = jpipe.lw_fluxes(jl, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                             J("emis"), jc, n_gauss_angles=n_angles,
                             backend="xla")
    ref_sw = jpipe.sw_fluxes(js, J("plev"), J("tlay"), jc, J("alb"),
                             J("tsi"), J("sza"), backend="xla")
    T = lambda k: torch.as_tensor(b[k])
    got = lwsw.lwsw_fluxes_plain(
        tl, ts, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
        T("emis")[:, None].expand(3, tl.ngpt), torch_concs(b["gases"]),
        T("alb"), T("tsi"), T("sza"), n_gauss_angles=n_angles)
    refs = (ref_lw.flux_up, ref_lw.flux_dn, ref_sw.flux_up, ref_sw.flux_dn)
    for band in (slice(0, 2), slice(2, 4)):
        scale = max(float(np.abs(np.asarray(r)).max()) for r in refs[band])
        for g, r in zip(got[band], refs[band]):
            assert tuple(g.shape) == (3, 301)
            err = float(np.abs(g.numpy() - np.asarray(r)).max()) / scale
            assert err <= 1e-7, err
    # That depth is the one the kernel stages in device memory.
    assert not staged.stage_plan(300, tl.ngpt, ts.ngpt, n_angles, GASES_LW,
                               GASES_SW, *H100).shared
