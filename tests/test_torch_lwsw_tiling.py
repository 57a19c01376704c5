"""PyTorch port: the merged kernel's staging plan and argument layout
(ops/cuda/staged.py), and its plain version on columns too deep for shared
memory.

The kernel itself (csrc/lwsw.cu) runs only on a card; these tests hold
what the host decides for it:

* ``stage_plan``: the staging floats per column, C (columns staged per
  block), the route (whole in shared memory, split with the LW rows in a
  device slice, or whole in the device slice), threads per block, and
  where the layer parameters go, against counts written out here by hand
  from csrc/common.cuh's row layout, and literal plans at an H100's
  limits;
* the parameter stage (csrc/staged.cuh): where ``stage_plan`` gives it by
  shape and where the parameters then sit, and the named barriers every
  plan needs (none above id 15);
* the launch: one per column chunk, counted once in its table mode's
  ``launches`` (added back on a replay), with the plan in its ``Tile``;
* the ctypes mirror of ``LwswArgs`` and of the staging plan ``Tile``
  (csrc/staged.cuh): field order as the C source declares it, offsets and
  size by hand;
* ``lwsw_fluxes_plain`` at nlay 300 (the device-staging case) at float64
  against JAX's XLA ``lw_fluxes`` + ``sw_fluxes``: max|d| / flux scale
  <= 1e-7, the bound of tests/test_torch_lwsw.py, so the reference the
  card holds that case against is itself held.
"""
import ctypes
import dataclasses
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
    """(floats per slot, C, shared, shared bytes per block, threads,
    parameters in the r_dif row, split) from csrc/common.cuh's layout.
    Split: where one whole column fits in a block but two do not, and two
    fit without their LW rows, which then go to the device slice; with an
    LW band wider than a warp at one angle also where whole columns fit
    one block of two per SM and, without their LW rows, two blocks do."""
    lw_rows = 3 * nlay if n_ang == 1 else 3 * nlay + 1  # tr/src or tau/B
    sw_rows = 5 * nlay + 2        # r_dif, t_dif, r_dir+1, t_dir, t+1
    acc = 2 * (nlay + 1) * (n_ang + 1)  # up, dn per LW angle, then SW
    per_layer = (8 + gases_lw[0] + 3 * gases_lw[1] + gases_sw[0]
                 + 3 * gases_sw[1])        # 4 Planck words with LW
    in_rows = ng_sw <= 32 and per_layer <= ng_sw
    floats = (lw_rows * ng_lw + sw_rows * ng_sw + acc
              + (0 if in_rows else per_layer * nlay))
    fit = limits[0] // (4 * floats)
    split = fit == 1 and limits[0] // (4 * (floats - lw_rows * ng_lw)) >= 2
    two_blocks = lambda f: 2 * (2 * 4 * f + 1024) <= limits[1]
    if ng_lw > 32 and n_ang == 1 and fit >= 2 and not two_blocks(floats):
        split = two_blocks(floats - lw_rows * ng_lw)
    if split:
        floats, fit = floats - lw_rows * ng_lw, 2
    if fit == 0:
        return floats, 2, False, 0, 512, in_rows, False
    c = min(fit, 2)
    smem = c * 4 * floats
    threads = 512 if 2 * (smem + 1024) <= limits[1] else 1024
    return floats, c, True, smem, threads, in_rows, split


@pytest.mark.parametrize("n_ang", [1, 2, 3, 4])
@pytest.mark.parametrize("ng_lw", [32, 36])
@pytest.mark.parametrize("nlay", [1, 2, 8, 60, 137, 300])
def test_stage_plan_matches_the_count_by_hand(nlay, ng_lw, n_ang):
    """nlay 137 is split at every angle count and both LW bands: one whole
    column fits in a block, two of their SW rows and accumulators do (and
    at one angle, with the parameter stage, two of those and a place of
    their own for the layer parameters).  lw_rrtmgp's 36 g-points are
    split at nlay 60 and one angle too: two whole columns fit one block
    per SM, two without their LW rows (and with the parameters' place)
    fit two."""
    p = staged.stage_plan(nlay, ng_lw, 27, n_ang, GASES_LW, GASES_SW, *H100)
    floats, c, shared, smem, threads, in_rows, split = by_hand(
        nlay, ng_lw, 27, n_ang)
    own = 26 * nlay if split and p.prm_stage else 0
    # Split at 36 g-points and one angle, each set sweeps the LW band's two
    # g-chunks on a warp each, with accumulators of its own.
    assert p.lw_warps == (2 if split and (ng_lw, n_ang) == (36, 1) else 1)
    more = own + 2 * (nlay + 1) * (p.lw_warps - 1)
    assert p.col_floats == floats + more
    assert p.bytes_per_column == 4 * (floats + more)
    assert (p.slots, p.shared, p.shared_bytes, p.threads) == (
        c, shared, smem + 4 * c * more, threads)
    assert p.split == split == (nlay == 137
                                or (ng_lw, nlay, n_ang) == (36, 60, 1))
    assert p.slice_floats == (p.lw_floats if split else
                              0 if shared else floats)
    assert (p.prm_floats == 0) == (in_rows and not own)
    assert p.prm_sw == 8 + GASES_LW[0] + 3 * GASES_LW[1]
    # Layer j's parameters sit in its r_dif row, after the LW rows (split:
    # the r_dif row starts the slot); with the parameter stage in its
    # first LW row, at the slot's start, or on the split route after the
    # accumulators, 26 a layer.
    if own:
        assert (p.prm_base, p.prm_stride) == (p.sw_floats + p.acc_floats,
                                              26)
    elif p.prm_stage:
        assert (p.prm_base, p.prm_stride) == (0, ng_lw)
    else:
        assert (p.prm_base, p.prm_stride) == (0 if split else p.lw_floats,
                                              27)


def test_stage_plan_at_the_main_path_and_the_edges():
    """Literal numbers for the cases the card runs (nlay 60: two columns
    of 56,632 B per block, two blocks of 512 threads per SM; lw_rrtmgp:
    a whole column of 59,512 B would leave one block of 1024 threads, so
    its LW rows go to the device slice and two blocks of two columns of
    33,592 B each fit, with the parameter stage's own place (6,240 B)
    39,832 B each still do, and with a second LW sweep warp's
    accumulators (488 B) 40,320 B)."""
    main = staged.stage_plan(60, 32, 27, 1, GASES_LW, GASES_SW, *H100)
    assert (main.lw_floats, main.sw_floats, main.acc_floats) == (5760, 8154,
                                                                 244)
    assert (main.bytes_per_column, main.slots, main.shared_bytes,
            main.threads) == (56632, 2, 113264, 512)
    four = staged.stage_plan(60, 32, 27, 4, GASES_LW, GASES_SW, *H100)
    assert (four.bytes_per_column, four.shared_bytes, four.threads) == (
        58224, 116448, 1024)          # two blocks would need 234,944 B
    rrtmgp = staged.stage_plan(60, 36, 27, 1, GASES_LW, GASES_SW, *H100)
    assert (rrtmgp.bytes_per_column, rrtmgp.slots, rrtmgp.threads,
            rrtmgp.route, rrtmgp.sm_blocks, rrtmgp.prm_stage,
            rrtmgp.lw_warps) == (40320, 2, 512, "split", 2, True, 2)
    assert 2 * (rrtmgp.shared_bytes + 1024) == 163328 <= H100[1]
    assert staged.stage_plan(60, 36, 27, 1, GASES_LW, GASES_SW, *H100,
                             lw_warps=1).bytes_per_column == 39832
    off = staged.stage_plan(60, 36, 27, 1, GASES_LW, GASES_SW, *H100,
                            param_stage=False, lw_warps=1)
    assert (off.bytes_per_column, off.route, off.sm_blocks) == (33592,
                                                               "split", 2)
    assert rrtmgp.lw_floats * 4 + off.bytes_per_column == 59512
    assert staged.stage_plan(60, 36, 27, 1, GASES_LW, GASES_SW, *H100,
                             param_stage=False).bytes_per_column == 34080
    assert staged.stage_plan(60, 36, 27, 1, GASES_LW, GASES_SW, *H100,
                             split=False).threads == 1024
    deep = staged.stage_plan(137, 32, 27, 1, GASES_LW, GASES_SW, *H100)
    # 129,012 B a whole column (LW rows 52,608 B): one fits, two do not;
    # without its LW rows 76,404 B, two fit, and with the parameter
    # stage's own place (14,248 B) 90,652 B, two still fit.
    assert (deep.lw_floats, deep.bytes_per_column, deep.slots,
            deep.shared_bytes, deep.route) == (13152, 90652, 2, 181304,
                                               "split")
    assert staged.stage_plan(137, 32, 27, 1, GASES_LW, GASES_SW, *H100,
                             param_stage=False).bytes_per_column == 76404
    device = staged.stage_plan(300, 32, 27, 1, GASES_LW, GASES_SW, *H100)
    assert (device.bytes_per_column, device.slots, device.shared,
            device.shared_bytes, device.threads) == (282232, 2, False, 0,
                                                     512)


@pytest.mark.parametrize("nlay", [1, 60, 137, 150, 300])
def test_stage_plan_follows_the_cards_shared_memory(nlay):
    """The limits are the card's: on one with 163 KB per block and 164 KB
    per SM (an A100's), nlay 60 keeps C = 2 in one block of 1024 threads
    per SM, nlay 137 fits one whole column and is split to two (152,808 B
    of 166,912), and nlay 150 fits one whole column and not two split."""
    small = (166_912, 167_936)
    p = staged.stage_plan(nlay, 32, 27, 1, GASES_LW, GASES_SW, *small)
    _, c, shared, smem, threads, _, split = by_hand(nlay, 32, 27, 1,
                                                    limits=small)
    assert (p.slots, p.shared, p.shared_bytes, p.threads, p.split) == (
        c, shared, smem, threads, split)
    if nlay == 60:
        assert (p.slots, p.threads) == (2, 1024)
    if nlay == 137:
        assert (p.route, p.slots, p.shared_bytes) == ("split", 2, 152808)
    if nlay == 150:
        assert (p.route, p.slots) == ("shared", 1)


# K1's plans in its block shape (staged.SHAPES["lwsw"]) at an H100's
# limits: (nlay, angles, route, C, S, threads, shared bytes per block,
# device slice floats per slot).  Split from nlay 124 to 208 at one angle
# (122 to 202 at three); then one whole column per block, then the device.
H100_PLANS = [
    (60, 1, "shared", 2, 2, 512, 113264, 0),
    (91, 1, "shared", 2, 2, 1024, 171544, 0),
    (123, 1, "shared", 2, 2, 1024, 231704, 0),
    (124, 1, "split", 2, 2, 1024, 164144, 11904),
    (137, 1, "split", 2, 2, 1024, 181304, 13152),
    (175, 1, "split", 2, 2, 1024, 231464, 16800),
    (176, 1, "split", 2, 2, 1024, 196176, 16896),
    (208, 1, "split", 2, 2, 1024, 231760, 19968),
    (209, 1, "shared", 1, 1, 1024, 196692, 0),
    (300, 1, "device", 2, 2, 512, 0, 70558),
    (60, 3, "shared", 2, 2, 512, 115472, 0),
    (91, 3, "shared", 2, 2, 1024, 174744, 0),
    (121, 3, "shared", 2, 2, 1024, 232104, 0),
    (122, 3, "split", 2, 2, 1024, 140064, 11744),
    (137, 3, "split", 2, 2, 1024, 157224, 13184),
    (202, 3, "split", 2, 2, 1024, 231584, 19424),
    (203, 3, "shared", 1, 1, 1024, 194444, 0),
    (300, 3, "device", 2, 2, 512, 0, 71794),
]


@pytest.mark.parametrize("nlay,n_ang,route,c,s,threads,smem,lw_slice",
                         H100_PLANS)
def test_merged_kernels_routes_at_h100_limits(nlay, n_ang, route, c, s,
                                              threads, smem, lw_slice):
    blocks, slots, sets = staged.SHAPES["lwsw"]
    p = staged.stage_plan(nlay, 32, 27, n_ang, GASES_LW, GASES_SW, *H100,
                          blocks_per_sm=blocks, max_slots=slots, sets=sets)
    assert (p.route, p.slots, p.sets, p.threads, p.shared_bytes,
            p.slice_floats) == (route, c, s, threads, smem, lw_slice)
    if route == "split":
        # The slice holds the LW rows alone: 32 g-points x 3 nlay (+1 at
        # 3 angles); the slot in shared memory the rest.
        assert lw_slice == p.lw_floats == 32 * (3 * nlay + (n_ang > 1))
        assert smem == c * 4 * (p.sw_floats + p.acc_floats + p.prm_floats)
    # The guarded plan (ring checker) keeps the route.
    g = dataclasses.replace(p, guard_floats=32)
    assert g.route == route
    assert g.slice_floats == lw_slice + (32 if route == "split" else
                                         0 if route == "shared" else 32)


# K1's plans at float64 (8 B a word) in its block shape at an H100's
# limits, beside the float32 plan of the same shape: (nlay, angles, route,
# C, threads, shared bytes per block, device slice words per slot, the
# parameter stage: at one angle, on the split route where its own place
# keeps C = 2, to nlay 87).  A column takes twice the bytes, so C = 2 fits
# one block per SM (768 threads, csrc/lwsw.cu F64_SHARED_THREADS) to nlay 61,
# the split route holds C = 2 from nlay 62 (where float32 still holds
# whole columns), and from nlay 124 (122 at 3 angles) no column fits: the
# device route, two blocks of 512 threads, where float32 splits.
F64_PLANS = [
    (47, 1, "shared", 2, 768, 177648, 0, True),
    (47, 3, "shared", 2, 768, 181232, 0, False),
    (60, 1, "shared", 2, 768, 226528, 0, True),
    (60, 3, "shared", 2, 768, 230944, 0, False),
    (80, 1, "split", 2, 768, 212128, 7680, True),
    (91, 1, "split", 2, 768, 203312, 8736, False),
    (91, 3, "split", 2, 768, 209200, 8768, False),
    (137, 1, "device", 2, 512, 0, 32253, False),
    (137, 3, "device", 2, 512, 0, 32837, False),
    (250, 1, "device", 2, 512, 0, 58808, False),
    (250, 3, "device", 2, 512, 0, 59844, False),
]


@pytest.mark.parametrize("nlay,n_ang,route,c,threads,smem,words,stage",
                         F64_PLANS)
def test_merged_kernels_f64_plans_at_h100_limits(nlay, n_ang, route, c,
                                                 threads, smem, words,
                                                 stage):
    blocks, slots, sets = staged.SHAPES["lwsw"]
    plan = lambda wb: staged.stage_plan(
        nlay, 32, 27, n_ang, GASES_LW, GASES_SW, *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets, word_bytes=wb)
    p, p32 = plan(8), plan(4)
    assert (p.route, p.slots, p.sets, p.threads, p.shared_bytes,
            p.slice_floats, p.prm_stage) == (route, c, 2, threads, smem,
                                             words, stage)
    # The same rows, accumulators and parameters as at float32, in words
    # of twice the size (the route's own: a split slot holds no LW rows,
    # and with the stage the parameters in a place of their own).
    assert p.word_bytes == 8 and p32.word_bytes == 4
    for q in (p, p32):
        assert q.prm_floats == (26 * nlay if q.split and q.prm_stage else 0)
    whole = lambda q: dataclasses.replace(q, split=False, prm_floats=0)
    assert whole(p).col_floats == whole(p32).col_floats
    assert p.bytes_per_column == 8 * p.col_floats
    assert (p.lw_floats, p.sw_floats, p.acc_floats) == (
        p32.lw_floats, p32.sw_floats, p32.acc_floats)
    # Whole columns in shared memory fit fewer times than at float32.
    fit = lambda q: H100[0] // q.bytes_per_column
    assert fit(whole(p)) == fit(whole(p32)) // 2 or fit(whole(p)) <= 1
    # The checked build's guard words keep the route.
    g = dataclasses.replace(p, guard_floats=32)
    assert g.route == route


def test_the_f64_thread_budget_mirrors_the_kernel():
    """staged.F64_SM_THREADS is lwsw.cu's F64_SHARED_THREADS, the launch
    bound of the double instantiations in shared memory; the device route
    keeps the 1024 threads (64 registers) of every other launch."""
    k = _constants("lwsw.cu")
    assert k["F64_SHARED_THREADS"] == staged.F64_SM_THREADS == 768
    assert staged.SM_THREADS == _constants("staged.cuh")["MAX_THREADS"]
    for nlay in range(1, 400, 7):
        for n_ang in (1, 3):
            p = staged.stage_plan(nlay, 32, 27, n_ang, GASES_LW, GASES_SW,
                                  *H100, max_slots=2, sets=2, word_bytes=8)
            per_sm = (staged.F64_SM_THREADS if p.shared
                      else staged.SM_THREADS)
            assert per_sm % p.threads == 0 and p.threads >= 32 * (
                p.sets * (n_ang + 1) + 1)


@pytest.mark.parametrize("kernel", ["lw", "sw"])
@pytest.mark.parametrize("nlay", [124, 137, 208])
def test_one_band_is_never_split(kernel, nlay):
    """K3 and K4 solve one band: nothing to split, C = 1 where one column
    fits (csrc/lw.cu and sw.cu refuse a split Tile)."""
    ng_lw, ng_sw = (32, 0) if kernel == "lw" else (0, 27)
    for n_ang in ((1, 3) if kernel == "lw" else (1,)):
        p = staged.stage_plan(nlay, ng_lw, ng_sw, n_ang,
                              GASES_LW if ng_lw else (0, 0),
                              GASES_SW if ng_sw else (0, 0), *H100)
        assert not p.split and p.route in ("shared", "device")


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
    """Field names of a struct in csrc/<source>, in declaration order (of
    the template ``<struct>T`` where common.cuh declares one, whose float
    instance has the plain name)."""
    src = (Path(lwsw.__file__).parents[2] / "csrc" / source).read_text()
    body = re.search(r"struct %sT? \{(.*?)\n\};" % struct, src,
                     re.S).group(1)
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
    # By hand: a pointer, then thirteen ints, padded to 8; the structs
    # before it as in common.cuh (Atmos 48, Grid 40, Band 728 twice (a
    # pointer, three ints, 16 slices of 44 bytes, padded to 8), LwSolve
    # 96, SwSolve 56 bytes).
    assert ctypes.sizeof(tile) == 8 + 13 * 4 + 4
    assert [getattr(tile, f).offset for f, _ in tile._fields_] \
        == [0] + list(range(8, 60, 4))
    sizes = [ctypes.sizeof(t) for t in (binding.Atmos, binding.Grid,
                                        binding.Band, binding.LwSolve,
                                        binding.SwSolve)]
    assert sizes == [48, 40, 728, 96, 56]
    assert args.tile.offset == 48 + 40 + 2 * 728 + 96 + 56
    assert ctypes.sizeof(args) == 1696 + 64


def test_f64_args_mirror_the_c_structs():
    """The double instantiation's argument struct: LwswArgs64 as lwsw.cu
    declares it, the templates' fields at double, sizes by hand (Atmos
    48, Grid 56 (a pointer, two ints, five doubles), GasSlice 72 (five
    ints padded to 24, six doubles), Band 1,176 twice, LwSolve 136,
    SwSolve 56, then the same 64-byte Tile)."""
    args = binding.LwswArgs64
    assert [f for f, _ in args._fields_] == c_fields("LwswArgs64")
    for struct in ("GasSlice", "Band", "Grid", "Atmos", "LwSolve",
                   "SwSolve"):
        f64, f32 = getattr(binding.F64, struct), getattr(binding, struct)
        assert [f for f, _ in f64._fields_] == [f for f, _ in f32._fields_]
        assert [f for f, _ in f64._fields_] == c_fields(struct, "common.cuh")
    sizes = [ctypes.sizeof(getattr(binding.F64, s)) for s in (
        "Atmos", "Grid", "GasSlice", "Band", "LwSolve", "SwSolve")]
    assert sizes == [48, 56, 72, 1176, 136, 56]
    assert args.tile.offset == 48 + 56 + 2 * 1176 + 136 + 56
    assert ctypes.sizeof(args) == 2648 + 64
    assert binding.args_type("lwsw", "f64") is args
    assert all(binding.args_type(n, m) is binding.ARGS[n]
               for n in ("lwsw", "lw", "sw") for m in ("exact", "fast"))


def test_tile_struct_carries_the_plan():
    p = staged.stage_plan(60, 32, 27, 3, GASES_LW, GASES_SW, *H100)
    t = staged.tile_struct(p, blocks=264)
    assert (t.stage, t.slots, t.sets, t.blocks, t.threads,
            t.shared_bytes) == (None, 2, 1, 264, 512, p.shared_bytes)
    assert (t.col_floats, t.lw_floats, t.sw_floats) == (
        p.col_floats, p.lw_floats, p.sw_floats)
    assert (t.prm_base, t.prm_stride, t.prm_sw) == (p.lw_floats, 27, 18)
    assert t.prm_stage == p.prm_stage == 0
    assert t.lw_warps == p.lw_warps == 1
    rrtmgp = staged.stage_plan(60, 36, 27, 1, GASES_LW, GASES_SW, *H100)
    assert staged.tile_struct(rrtmgp).lw_warps == rrtmgp.lw_warps == 2
    for stage in (False, True):
        q = staged.stage_plan(60, 32, 27, 1, GASES_LW, GASES_SW, *H100,
                              param_stage=stage)
        t = staged.tile_struct(q)
        assert t.prm_stage == int(q.prm_stage) == stage
        assert (t.prm_base, t.prm_stride) == ((0, 32) if stage
                                              else (q.lw_floats, 27))


def test_tile_struct_carries_the_split_plan():
    """The split route's Tile: shared memory per block and the LW slice's
    pointer in ``stage`` (csrc/staged.cuh staging_of reads the route from
    both), a slot's shared floats without the LW rows, the parameters at
    their own place with the parameter stage (the start of its SW rows
    without)."""
    p = staged.stage_plan(137, 32, 27, 1, GASES_LW, GASES_SW, *H100,
                          max_slots=2, sets=2)
    stage = torch.empty((132, p.slots, p.slice_floats))
    t = staged.tile_struct(p, blocks=132, stage=stage)
    assert t.stage == stage.data_ptr() and t.shared_bytes > 0
    assert (t.slots, t.sets, t.threads) == (2, 2, 1024)
    assert (t.col_floats, t.lw_floats, t.sw_floats) == (
        22663, 13152, 18549)
    # With the parameter stage (one angle, C = 2) the parameters follow
    # the slot's accumulators, 26 a layer; without it they start its SW
    # rows, and the slot is 3,562 floats shorter.
    assert t.prm_stage == 1 and t.shared_bytes == 181304
    assert (t.prm_base, t.prm_stride, t.prm_sw) == (18549 + 552, 26, 18)
    off = staged.tile_struct(staged.stage_plan(
        137, 32, 27, 1, GASES_LW, GASES_SW, *H100, max_slots=2, sets=2,
        param_stage=False))
    assert (off.prm_stage, off.prm_base, off.prm_stride) == (0, 0, 27)
    assert (off.col_floats, off.shared_bytes) == (19101, 152808)
    # 13.9 MB of LW slices on 132 blocks.
    assert 4 * stage.numel() == 4 * 132 * 2 * 13152 == 13_888_512


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


def _stub_launch(monkeypatch, kernel, calls):
    """A stand-in for ``kernel``'s build whose entry points (one per
    launch mode) append (the mode, the launch's argument struct) to
    ``calls``, and no card: the current device and stream stubbed."""
    import contextlib
    import types

    def entry(mode):
        return lambda args, stream: calls.append((mode, args._obj)) or 0
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    return types.SimpleNamespace(**{
        f"ecckd_{kernel}_launch{binding.MODES[mode][0]}": entry(mode)
        for mode in binding.KERNEL_MODES[kernel]})


@pytest.mark.parametrize("mode", ["exact", "fast", "f64"])
@pytest.mark.parametrize("ncol,chunk", [(1037, 512), (512, 512),
                                        (1, 65536), (65537, 65536)])
def test_launch_chunks_counts_each_launch_once(monkeypatch, mode, ncol,
                                               chunk):
    """One launch per column chunk, each on the mode's entry point and
    adding one to the mode's count (``launches``, ``fast_launches`` or
    ``f64_launches``) and to nothing else; the launch itself stubbed."""
    import types
    calls = []
    lib = _stub_launch(monkeypatch, "lwsw", calls)
    before = {"launches": 5, "fast_launches": 7, "f64_launches": 9}
    counted = types.SimpleNamespace(**before)
    spans = []
    args = binding.args_type("lwsw", mode)
    binding.launch_chunks("lwsw", ncol, chunk,
                          lambda c0, c1: spans.append((c0, c1)) or args(),
                          counted, None, mode, lib)
    n = -(-ncol // chunk)
    assert spans == [(c0, min(c0 + chunk, ncol))
                     for c0 in range(0, ncol, chunk)]
    assert [m for m, _ in calls] == [mode] * n
    assert all(type(a) is args for _, a in calls)
    counter = binding.MODES[mode][1]
    assert vars(counted) == {**before, counter: before[counter] + n}


@pytest.mark.parametrize("kernel", ["lwsw", "lw"])
@pytest.mark.parametrize("n_angles", [1, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_run_staged_hands_the_plan_to_the_launch(monkeypatch, ckd_paths,
                                                 kernel, n_angles, fast):
    """Each launch of the merged kernel or the LW kernel carries the
    staging plan in its ``Tile`` (C, S, shared bytes, the parameter stage)
    and the angles in its ``LwSolve``, and counts once in the mode's
    ``launches``: the route, the stage and the angles are read from the
    plan, not counted.  The prepared inputs are real (on the CPU), the
    card's properties and the launch stubbed."""
    import types
    from ecckd_tpu_torch.models.loader import load_ckd_model
    calls = []
    lib = _stub_launch(monkeypatch, kernel, calls)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(staged, "blocks_per_sm", lambda *a: 1)
    lw_m, sw_m = (load_ckd_model(ckd_paths[k], dtype=torch.float32)
                  for k in ("lw", "sw"))
    b = flux_batch(37, 60, 2, torch.float32)
    T = lambda k: torch.as_tensor(b[k])
    emis = T("emis")[:, None].expand(37, lw_m.ngpt).contiguous()
    concs = torch_concs(b["gases"], torch.float32)
    if kernel == "lwsw":
        atm, lw_in, sw_in = plan.prepare(
            lw_m, sw_m, T("plev"), T("tlay"), T("tlev"), T("tsfc"), emis,
            concs, T("alb"), T("tsi"), T("sza"), n_angles, fast)
    else:
        (atm, lw_in), sw_in = plan.prepare_lw(
            lw_m, T("plev"), T("tlay"), T("tlev"), T("tsfc"), emis, concs,
            n_angles, fast), None
    p = staged.stage_plan(60, lw_m.ngpt, sw_m.ngpt if sw_in else 0,
                          n_angles, GASES_LW, GASES_SW if sw_in else (0, 0),
                          *H100)
    # The stage is the merged kernel's, at one angle (stage_rule).
    assert p.route == "shared"
    assert p.prm_stage == (kernel == "lwsw" and n_angles == 1)
    counted = types.SimpleNamespace(launches=0, fast_launches=0)
    staged.run_staged(atm, lw_in, sw_in, 16, counted, plan=p, lib=lib)
    assert len(calls) == 3                              # 16, 16, 5
    for mode, args in calls:
        assert mode == ("fast" if fast else "exact")
        t = args.tile
        assert (t.slots, t.sets, t.shared_bytes, t.prm_stage) == (
            p.slots, p.sets, p.shared_bytes, int(p.prm_stage))
        assert t.stage is None and args.lw.n_ang == n_angles
    assert vars(counted) == ({"launches": 0, "fast_launches": 3} if fast
                             else {"launches": 3, "fast_launches": 0})


def test_capture_counters_are_the_wrappers_launches():
    """capture.jit adds a replay's launches back per counter: each of the
    three kernel wrappers' counts, one per launch mode (two each, and the
    merged kernel's f64 count), and the merged kernel's Jacobian's, and no
    other."""
    from ecckd_tpu_torch.ops.cuda.lw import lw_fluxes_cuda
    from ecckd_tpu_torch.ops.cuda.sw import sw_fluxes_cuda
    from ecckd_tpu_torch.utils import capture
    assert capture.COUNTERS == tuple(
        (w, c) for w, cs in (
            (lwsw.lwsw_fluxes_cuda,
             ("launches", "fast_launches", "f64_launches")),
            (lw_fluxes_cuda, ("launches", "fast_launches")),
            (sw_fluxes_cuda, ("launches", "fast_launches")),
            (lwsw.lwsw_fluxes_cuda, ("jac_launches",)))
        for c in cs)
    for w, c in capture.COUNTERS:
        assert isinstance(getattr(w, c), int)


# The parameter stage by shape, in each kernel's block shape
# (staged.SHAPES) at an H100's limits: (kernel, nlay, angles, stage).  It
# takes an LW band of one g-chunk, whole columns in shared memory or the
# split route where the parameters' own place keeps C, and the rule's
# shapes (stage_rule: one angle, C >= 2); it is the merged kernel's alone
# (with whole columns its LW sweep warps run it beside the SW sweep).
STAGE_PLANS = [
    ("lwsw", 60, 1, True),
    ("lwsw", 30, 1, True),
    ("lwsw", 91, 1, True),
    ("lwsw", 123, 1, True),
    ("lwsw", 60, 3, False),
    ("lwsw", 60, 2, False),
    ("lwsw", 137, 1, True),       # split: the LW rows in the device slice
    ("lwsw", 137, 3, False),      # split at 3 angles
    ("lwsw", 208, 1, False),      # split, no room for the parameters' place
    ("lwsw", 220, 1, False),      # one whole column per block
    ("lwsw", 300, 1, False),      # device staging
    ("lw", 60, 1, False),
    ("lw", 137, 1, False),
    ("lw", 60, 3, False),
    ("sw", 60, 1, False),
    ("sw", 137, 1, False),
]


def _shape_plan(kernel, nlay, n_ang, ng_lw=32, **kw):
    blocks, slots, sets = staged.SHAPES[kernel]
    return staged.stage_plan(
        nlay, ng_lw if kernel != "sw" else 0, 27 if kernel != "lw" else 0,
        n_ang, GASES_LW if kernel != "sw" else (0, 0),
        GASES_SW if kernel != "lw" else (0, 0), *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets, **kw)


@pytest.mark.parametrize("kernel,nlay,n_ang,stage", STAGE_PLANS)
def test_stage_plan_gives_the_parameter_stage_by_shape(kernel, nlay, n_ang,
                                                       stage):
    p = _shape_plan(kernel, nlay, n_ang)
    off = _shape_plan(kernel, nlay, n_ang, param_stage=False)
    assert p.prm_stage == stage and not off.prm_stage
    # The stage moves the parameters, to the layer's first LW row (whole
    # columns) or to their own place (split), and changes nothing else:
    # the block keeps its threads, C and S, and whole columns their bytes.
    own = 26 * nlay if stage and p.split else 0
    assert dataclasses.replace(p, prm_stage=False, prm_base=off.prm_base,
                               prm_stride=off.prm_stride,
                               prm_floats=0) == off
    assert p.prm_floats == own
    if own:
        assert (p.prm_base, p.prm_stride) == (p.sw_floats + p.acc_floats,
                                              26)
    elif stage:
        assert (p.prm_base, p.prm_stride) == (0, 32)
    else:
        assert p == off
    # Asked for where it cannot run, it raises; the rule reads the shape
    # alone.
    if kernel != "lwsw" or off.route == "device" or (
            off.route == "split" and n_ang == 1 and not stage):
        with pytest.raises(ValueError):
            _shape_plan(kernel, nlay, n_ang, param_stage=True)
    assert _shape_plan(kernel, nlay, n_ang) == p


@pytest.mark.parametrize("nlay,ng_lw,threads", [
    (124, 32, 1024), (137, 32, 1024), (160, 32, 1024), (175, 32, 1024),
    (137, 36, 1024), (60, 36, 512)])
def test_split_route_takes_the_parameter_stage(nlay, ng_lw, threads):
    """f32 nlay 124-175 at one angle, K1's split route: the stage puts
    the parameters in a place of their own after the slot's accumulators
    in shared memory (26 a layer), which no sweep reads, so the optics
    warps can compute them before they wait for the slot; it keeps the
    block's C, S, threads and slice, and the slot grows by that place.
    lw_rrtmgp's 36 g-points (pairs over the lanes, which read only their
    own warp's layers' parameters) take it there too, and at nlay 60,
    where its two blocks of 512 threads per SM still fit."""
    p = _shape_plan("lwsw", nlay, 1, ng_lw=ng_lw)
    off = _shape_plan("lwsw", nlay, 1, ng_lw=ng_lw, param_stage=False)
    assert (p.route, p.prm_stage) == ("split", True)
    assert (off.route, off.prm_stage) == ("split", False)
    assert (p.slots, p.sets, p.threads, p.slice_floats) == (
        off.slots, off.sets, off.threads, off.slice_floats) == (
            2, 2, threads, 3 * ng_lw * nlay)
    assert p.shared_bytes == off.shared_bytes + 2 * 4 * 26 * nlay <= H100[0]
    assert p.sm_blocks * (p.shared_bytes + 1024) <= H100[1]
    assert (p.prm_base, p.prm_stride, p.prm_floats) == (
        p.sw_floats + p.acc_floats, 26, 26 * nlay)
    # Without the stage the parameters start the slot's SW rows.
    assert (off.prm_base, off.prm_stride, off.prm_floats) == (0, 27, 0)
    # A layer's 26 parameters: 4 + 4 Planck words and the bands' gases.
    assert p.prm_sw + GASES_SW[0] + 3 * GASES_SW[1] == 26


@pytest.mark.parametrize("nlay,n_ang,ng_lw", [(176, 1, 32), (208, 1, 32),
                                              (137, 3, 32), (91, 1, 36),
                                              (103, 1, 36)])
def test_split_route_still_declines_the_stage(nlay, n_ang, ng_lw):
    """The split route without the stage: from nlay 176 at one angle the
    parameters' own place would leave one column per block (asked for,
    it raises); at 3 angles the rule declines it (the set's LW sweep
    warps leave no room: stage_plan's timings) though it fits; with
    lw_rrtmgp's 36 g-points at nlay 88-103 two blocks of 512 threads per
    SM would no longer fit with it, and asked for there it raises."""
    p = _shape_plan("lwsw", nlay, n_ang, ng_lw=ng_lw)
    assert (p.route, p.prm_stage, p.slots) == ("split", False, 2)
    if ng_lw == 36:
        own = 2 * (p.shared_bytes + 2 * 4 * 26 * nlay + 1024)
        assert (p.sm_blocks, p.threads) == (2, 512) and own > H100[1]
    assert (p.prm_base, p.prm_stride, p.prm_floats) == (0, 27, 0)
    if n_ang == 1:
        with pytest.raises(ValueError):
            _shape_plan("lwsw", nlay, n_ang, ng_lw=ng_lw, param_stage=True)
    else:
        assert _shape_plan("lwsw", nlay, n_ang, param_stage=True).prm_stage


@pytest.mark.parametrize("kernel", ["lwsw", "lw", "sw"])
@pytest.mark.parametrize("word_bytes", [4, 8])
def test_only_split_pairs_plans_take_chunk_warps(kernel, word_bytes):
    """One LW sweep warp per g-chunk (``lw_warps`` 2) is the one field
    ``stage_plan`` gained; asked for one warp an angle (``lw_warps=1``) it
    plans as it did without the field.  Over nlay 1-400, band widths,
    gas sets, temperature grids and 1-4 angles, every plan at <= 32 LW
    g-points, at float64, at 2-4 angles, of a run-time shape, of K3 and
    K4, and on whole columns is that plan; the others (36 g-points in
    the pairs layout, float32, one angle, split) add the second warp's
    accumulators where they fit, 2 (nlay + 1) words after the first's
    (the parameters' own place moves by as much), and nothing else."""
    blocks, slots, sets = staged.SHAPES[kernel]
    engaged = 0
    for ng, gases, n_t in ((16, GASES_LW, 6), (32, GASES_LW, 6),
                           (36, GASES_LW, 6), (36, (4, 1), 6),
                           (36, GASES_LW, 5), (48, GASES_LW, 6)):
        for n_ang in ((1, 2, 3, 4) if kernel != "sw" else (1,)):
            for nlay in range(1, 401):
                kw = dict(blocks_per_sm=blocks, max_slots=slots, sets=sets,
                          word_bytes=word_bytes, n_t=n_t)
                args = (nlay, ng if kernel != "sw" else 0,
                        27 if kernel != "lw" else 0, n_ang,
                        gases if kernel != "sw" else (0, 0),
                        GASES_SW if kernel != "lw" else (0, 0), *H100)
                p = staged.stage_plan(*args, **kw)
                one = staged.stage_plan(*args, **kw, lw_warps=1)
                assert one.lw_warps == 1
                if p.lw_warps == 1:
                    assert p == one
                    continue
                engaged += 1
                assert (kernel, word_bytes, ng, gases, n_t, n_ang) == (
                    "lwsw", 4, 36, GASES_LW, 6, 1) and p.split
                extra = 2 * (nlay + 1)
                assert p == dataclasses.replace(
                    one, lw_warps=2, acc_floats=one.acc_floats + extra,
                    prm_base=one.prm_base + (extra if one.prm_floats
                                             else 0))
    assert (engaged > 0) == ((kernel, word_bytes) == ("lwsw", 4))


def test_no_stage_for_lw_rows_of_two_g_chunks():
    """lw_rrtmgp's 36 g-points: with whole columns a step of the LW
    optics writes a layer's LW row before a later step reads its
    parameters, so they stay in the SW row and the stage is refused
    (asked for, it raises); on the split route at nlay 60 the stage takes
    its own place after the accumulators, which no LW row shares."""
    whole = _shape_plan("lwsw", 60, 1, ng_lw=36, split=False)
    assert whole.route == "shared" and not whole.prm_stage
    assert (whole.prm_base, whole.prm_stride) == (whole.lw_floats, 27)
    with pytest.raises(ValueError):
        _shape_plan("lwsw", 60, 1, ng_lw=36, split=False, param_stage=True)
    p = _shape_plan("lwsw", 60, 1, ng_lw=36)
    assert (p.route, p.prm_stage) == ("split", True)
    assert (p.prm_base, p.prm_stride, p.prm_floats) == (
        p.sw_floats + p.acc_floats, 26, 26 * 60)
    assert not _shape_plan("lw", 60, 1, ng_lw=36).prm_stage


def _constants(source):
    """The ``constexpr int`` of csrc/<source> that are sums of numbers and
    earlier ones, as a dict."""
    src = (Path(lwsw.__file__).parents[2] / "csrc" / source).read_text()
    out = {}
    for decl in re.findall(r"constexpr int ([^;]*);", src):
        for item in decl.split(","):
            name, expr = (x.strip() for x in item.split("="))
            terms = [t.strip() for t in expr.split("+")]
            if all(t.isdigit() or t in out for t in terms):
                out[name] = sum(int(t) if t.isdigit() else out[t]
                                for t in terms)
    return out


def test_no_plan_needs_a_barrier_id_above_15():
    """Hopper's 16 named barriers per block (0: __syncthreads): FULL and
    FREE per slot, LW_DONE per set and the planted faults' own, over every
    kernel's plans at nlay 1-600 and 1-4 angles, with and without the
    parameter stage (which needs no barrier of its own: the LW warps write
    before they arrive at FREE); the Python limit mirrors
    csrc/staged.cuh's."""
    k = _constants("staged.cuh")
    assert k["NAMED_BARRIERS"] == 16 and k["BAR_FULL"] == 1
    assert k["MAX_SLOTS"] == staged.SLOT_LIMIT
    assert k["BAR_PLANT"] <= 15
    stages = 0
    for kernel in ("lwsw", "lw", "sw"):
        for nlay in range(1, 601):
            for n_ang in ((1, 2, 3, 4) if kernel != "sw" else (1,)):
                p = _shape_plan(kernel, nlay, n_ang)
                stages += p.prm_stage
                ids = ([k["BAR_FULL"] + s for s in range(p.slots)]
                       + [k["BAR_FREE"] + s for s in range(p.slots)]
                       + [k["BAR_LW_DONE"] + s for s in range(p.sets)])
                assert len(set(ids)) == len(ids) and max(ids) <= 15
                assert k["BAR_PLANT"] not in ids
    assert stages > 0


def test_replays_add_back_the_launches(monkeypatch):
    """capture.jit adds a replay's launches back per counter
    (``capture._add_counts`` of the eager call's deltas): a replay of a
    call that ran 8 exact and 3 fast launches counts 8 and 3 more."""
    from ecckd_tpu_torch.utils import capture
    w = lwsw.lwsw_fluxes_cuda
    for c in ("launches", "fast_launches"):
        monkeypatch.setattr(w, c, getattr(w, c))
    before = capture._counts()
    w.launches += 8
    w.fast_launches += 3
    delta = [a - b for a, b in zip(capture._counts(), before)]
    capture._add_counts(delta)
    at = lambda c: before[capture.COUNTERS.index((w, c))]
    assert (w.launches, w.fast_launches) == (at("launches") + 16,
                                             at("fast_launches") + 6)
    assert sum(map(abs, delta)) == 11
