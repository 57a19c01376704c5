"""PyTorch port: RTE's LW surface-temperature Jacobian (``flux_up_jac``) on
the CPU.

* The torch path's ``flux_up_jac`` (``solvers/lw.rte_lw``'s second
  recurrence on the up sweep) is the change of flux_up over a 1 K warmer
  surface: two float64 solves agree to rounding at 1-4 angles, in both
  layer orders, at nlay 1, 60 and 91.
* The Planck table's first difference (``ops/planck.planck_source_jac``)
  is planck_source(T + 1 K) - planck_source(T) across the table and its
  clamped ends.
* The torch path matches the benchmark's float64 reference
  (``radbench/reference/rte_jac.py``) within 1e-10.
* Without the flag every output is what it was, bit for bit, and the LW
  result carries no Jacobian.
* ``_kernel_refusal``'s reasons: K3, float64, 3 angles, 36 g-points, a
  run-time shape; ``staged.jac_refusal``'s route at an H100's limits.
* ``stage_plan`` without the flag gives the plans it gave before the
  Jacobian (a digest of 48,000 plans: nlay 1-400, five band widths, the
  three kernels, 1-4 angles, both word sizes); with it each slot holds one
  more row of (nlay + 1) words.
* The plain version (``lwsw_fluxes_plain``) carries the Jacobian too.
* The binding: the Jacobian's argument struct mirrors the C one, its
  launches count in ``jac_launches`` in either table mode, and
  ``run_staged`` hands the kernel the fifth output and the plan with the
  row (the launch stubbed).

This file imports nothing of JAX or of the JAX package.
"""
import ctypes
import dataclasses
import hashlib
import re
import types
from pathlib import Path

import pytest
import torch

from ecckd_tpu_torch import pipeline
from ecckd_tpu_torch.fluxes import FluxesBroadband
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.ops import planck
from ecckd_tpu_torch.ops.cuda import binding, lwsw, plan, staged
from ecckd_tpu_torch.solvers.lw import rte_lw
from ecckd_tpu_torch.utils.tree import tree_leaves, tree_map
from radbench import inputs, solve
from radbench.reference import ckd as ref_ckd
from radbench.reference import rte_jac

torch.set_num_threads(2)
H100 = (232_448, 233_472)
CSRC = Path(lwsw.__file__).resolve().parents[2] / "csrc"
TOL = 1e-10
SHIPPED = dict(lw=(32, (7, 1)), sw=(27, (5, 1)))
PARENT_PLANS = ("ce495b24ab2d5990ed6c29e00a33496f9bea61840380d669661e5a69"
                "acf381f5")
"""sha256 of the reprs of ``all_plans()`` before the Jacobian."""
BANDS = (((32, 27), (7, 1), (5, 1)), ((36, 27), (7, 1), (5, 1)),
         ((16, 14), (4, 1), (3, 1)), ((48, 32), (6, 2), (5, 1)),
         ((64, 16), (7, 1), (2, 0)))
"""(LW, SW) g-points and (dense, LUT) gases of the five band widths."""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """lw_fsck, lw_rrtmgp and sw_wide ckd files (the benchmark's writer)."""
    d = tmp_path_factory.mktemp("ckd_jac")
    out = {}
    for kind in ("lw_fsck", "lw_rrtmgp", "sw_wide"):
        out[kind] = str(d / f"{kind}.nc")
        inputs.write_ckd(out[kind], kind, 7)
    return out


@pytest.fixture(scope="module")
def models(files):
    return {(k, dt): load_ckd_model(p, dtype=dt)
            for k, p in files.items()
            for dt in (torch.float32, torch.float64)}


def make(nlay, dtype=torch.float64, ncol=6, seed=11):
    b = inputs.make_batch(ncol, nlay, inputs.generator(seed, "cpu"), "cpu")
    out = {k: v.to(dtype) for k, v in b.items() if k != "concs"}
    out["concs"] = {k: v.to(dtype) for k, v in b["concs"].items()}
    return out


def flipped(b):
    """The batch with its layers bottom up (top_at_1=False)."""
    f = lambda x: torch.flip(x, (1,))
    out = dict(b, plev=f(b["plev"]), tlay=f(b["tlay"]), tlev=f(b["tlev"]))
    out["concs"] = {k: f(v) if v.ndim == 2 else v
                    for k, v in b["concs"].items()}
    return out


def lw_call(models, b, tsfc, n_ang=1, top=True, jac=True,
            dtype=torch.float64):
    return pipeline.lw_fluxes(
        models["lw_fsck", dtype], b["plev"], b["tlay"], b["tlev"], tsfc,
        b["emis"], solve.gas_concs(b), n_gauss_angles=n_ang, top_at_1=top,
        backend="torch", flux_up_jac=jac)


def lwsw_call(models, b, dtype=torch.float64, jac=True, lw="lw_fsck",
              n_ang=1):
    return pipeline.lw_sw_fluxes(
        models[lw, dtype], models["sw_wide", dtype], b["plev"], b["tlay"],
        b["tlev"], b["tsfc"], b["emis"], solve.gas_concs(b), b["alb"],
        b["tsi"], b["sza"], n_gauss_angles=n_ang, backend="torch",
        flux_up_jac=jac)


def rel(got, want):
    """max |got - want| over |want|'s largest, per column, at worst."""
    return float(((got - want).abs().amax(1)
                  / want.abs().amax(1)).max())


@pytest.mark.parametrize("nlay", [1, 60, 91])
@pytest.mark.parametrize("top", [True, False])
@pytest.mark.parametrize("n_ang", [1, 2, 3, 4])
def test_the_jacobian_is_the_change_over_one_kelvin(models, nlay, top,
                                                     n_ang):
    b = make(nlay)
    if not top:
        b = flipped(b)
    at = lw_call(models, b, b["tsfc"], n_ang, top)
    warm = lw_call(models, b, b["tsfc"] + 1.0, n_ang, top, jac=False)
    assert at.flux_up_jac.shape == at.flux_up.shape
    assert bool((at.flux_up_jac > 0).all())
    assert rel(at.flux_up_jac, warm.flux_up - at.flux_up) <= TOL
    # The surface level holds the largest derivative; a warmer surface
    # leaves the down flux as it is.
    sfc = -1 if top else 0
    assert torch.equal(at.flux_up_jac.amax(1), at.flux_up_jac[:, sfc])
    assert torch.equal(warm.flux_dn, at.flux_dn)


def test_planck_difference_across_the_table_and_its_ends(models, files):
    m = models["lw_fsck", torch.float64]
    pt, pf = m.planck_temperature, m.planck_function
    t0, t_last = float(pt[0]), float(pt[-1])
    temps = torch.tensor([60.0, t0 - 1.7, t0 - 1.0, t0 - 0.4, t0, t0 + 0.25,
                          200.5, 287.3, t_last - 1.5, t_last - 1.0,
                          t_last - 0.3, t_last, t_last + 4.2],
                         dtype=torch.float64)
    got = planck.planck_source_jac(temps, pt, pf)
    want = (planck.planck_source(temps + 1.0, pt, pf)
            - planck.planck_source(temps, pt, pf))
    assert got.shape == (len(temps), m.ngpt)
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-11
    # The reference's own form of the same difference.
    ref = rte_jac.planck_change(ref_ckd.read_ckd(files["lw_fsck"]), temps)
    assert float(((got - ref).abs() / ref.abs()).max()) <= TOL


@pytest.mark.parametrize("n_ang", [1, 3])
def test_the_torch_path_matches_the_reference_at_f64(models, files, n_ang):
    b = make(60, ncol=8)
    lw, sw = lwsw_call(models, b, n_ang=n_ang)
    ref = rte_jac.fluxes(ref_ckd.read_ckd(files["lw_fsck"]),
                         ref_ckd.read_ckd(files["sw_wide"]), b, n_ang,
                         block=4)
    got = (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, lw.flux_up_jac)
    for k, (g, r) in enumerate(zip(got, ref)):
        scale = float(ref[k - k % 2].abs().max()) if k < 4 else \
            float(r.abs().max())
        assert float((g - r).abs().max()) / scale <= TOL, k
    assert not bool(ref[5].any())
    # The same solve in float32 leaves the bound.
    lw32, _ = lwsw_call(models, b, torch.float32, n_ang=n_ang)
    assert float((lw32.flux_up_jac.double() - ref[4]).abs().max()) \
        / float(ref[4].abs().max()) > TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_without_the_flag_every_output_is_as_it_was(models, dtype):
    b = make(60, dtype)
    plain = lwsw_call(models, b, dtype, jac=False)
    with_jac = lwsw_call(models, b, dtype, jac=True)
    assert plain[0].flux_up_jac is None and plain[1].flux_up_jac is None
    assert with_jac[1].flux_up_jac is None
    for f, g in zip(plain, with_jac):
        assert torch.equal(f.flux_up, g.flux_up)
        assert torch.equal(f.flux_dn, g.flux_dn)
    # The result's tree: two leaves without the Jacobian, three with it.
    assert len(tree_leaves(plain[0])) == 2
    assert len(tree_leaves(with_jac[0])) == 3
    copy = tree_map(lambda t: t.clone(), with_jac[0])
    assert isinstance(copy, FluxesBroadband)
    assert torch.equal(copy.flux_up_jac, with_jac[0].flux_up_jac)
    # rte_lw returns its pair alone without the flag.
    from ecckd_tpu_torch.models.gas_optics import gas_optics_lw
    m = models["lw_fsck", dtype]
    props, src = gas_optics_lw(m, b["plev"], b["tlay"], b["tsfc"],
                               solve.gas_concs(b), b["tlev"])
    emis = b["emis"][:, None].expand(-1, m.ngpt)
    pair = rte_lw(props, src, emis)
    triple = rte_lw(props, src, emis, flux_up_jac=True)
    assert len(pair) == 2 and len(triple) == 3
    assert all(torch.equal(x, y) for x, y in zip(pair, triple))
    with pytest.raises(ValueError, match="sfc_source_jac"):
        rte_lw(props, dataclasses.replace(src, sfc_source_jac=None), emis,
               flux_up_jac=True)


@pytest.mark.parametrize("nlay", [1, 91])
@pytest.mark.parametrize("fast", [False, True])
def test_the_plain_version_carries_the_jacobian(models, nlay, fast):
    """``lwsw_fluxes_plain(..., flux_up_jac=True)``, what the kernel's
    Jacobian instantiation is held against on the card: its four fluxes
    are the plain version's without the flag, bit for bit, and its J the
    torch path's within TOL at float64 (exact table)."""
    b = make(nlay, ncol=7)
    mode = "bf16" if fast else "bf16x3"
    lw_m, sw_m = models["lw_fsck", torch.float64], models["sw_wide",
                                                          torch.float64]
    emis = b["emis"][:, None].expand(-1, lw_m.ngpt).contiguous()
    args = (lw_m, sw_m, b["plev"], b["tlay"], b["tlev"], b["tsfc"], emis,
            solve.gas_concs(b), b["alb"], b["tsi"], b["sza"])
    plain = lwsw.lwsw_fluxes_plain(*args, mxu_mode=mode)
    got = lwsw.lwsw_fluxes_plain(*args, mxu_mode=mode, flux_up_jac=True)
    assert len(plain) == 4 and len(got) == 5
    assert all(torch.equal(x, y) for x, y in zip(plain, got))
    if not fast:
        want = lwsw_call(models, b)[0].flux_up_jac
        assert rel(got[4], want) <= TOL
    warm = lwsw.lwsw_fluxes_plain(*args[:5], b["tsfc"] + 1.0, *args[6:],
                                  mxu_mode=mode)
    assert rel(got[4], warm[0] - plain[0]) <= 1e-9


def test_the_smokes_bound_adds_the_roofline_metrics_jacobian(models):
    """chip_smoke.kernel_bound with ``jac``: the operations and bytes that
    ``lwsw_jac_roofline`` adds to the frozen count, on top of the
    bound without it."""
    import chip_smoke
    from radbench.metrics import lwsw_jac_roofline
    ncol, nlay = 6, 91
    b = make(nlay, torch.float32, ncol=ncol)
    lw_m, sw_m = (models[k, torch.float32] for k in ("lw_fsck", "sw_wide"))
    emis = b["emis"][:, None].expand(ncol, lw_m.ngpt).contiguous()
    prep = plan.prepare(lw_m, sw_m, b["plev"], b["tlay"], b["tlev"],
                        b["tsfc"], emis, solve.gas_concs(b), b["alb"],
                        b["tsi"], b["sza"], 1)
    base, jac = chip_smoke.kernel_bound(prep), chip_smoke.kernel_bound(
        prep, jac=True)
    run = types.SimpleNamespace(
        unit_columns=ncol, config={"nlay": nlay, "n_gauss_angles": 1},
        lw=types.SimpleNamespace(ngpt=lw_m.ngpt),
        work={"ops": 0, "bytes": 0})
    added = lwsw_jac_roofline.jac_work(run)
    assert jac["ops"] - base["ops"] == added["ops"] > 0
    assert jac["bytes"] - base["bytes"] == added["bytes"] == ncol * (
        nlay + 1) * 4


def test_column_chunks_carry_the_jacobian(models):
    b = make(20, ncol=10)
    whole = lw_call(models, b, b["tsfc"])
    chunked = pipeline.lw_fluxes(
        models["lw_fsck", torch.float64], b["plev"], b["tlay"], b["tlev"],
        b["tsfc"], b["emis"], solve.gas_concs(b), column_chunk=4,
        backend="torch", flux_up_jac=True)
    assert torch.allclose(chunked.flux_up_jac, whole.flux_up_jac,
                          rtol=1e-14, atol=0.0)


def refusal(models, b, n_ang=1, lw="lw_fsck", kernel="lwsw", gases=None,
            dtype=None):
    tlay = b["tlay"] if dtype is None else b["tlay"].to(dtype)
    concs = solve.gas_concs(b)
    return pipeline._kernel_refusal(
        tlay, True, n_ang, (), kernel, True,
        (models[lw, torch.float32], models["sw_wide", torch.float32]),
        gases or concs.names)


@pytest.mark.parametrize("case,match", [
    ("k3", "LW kernel K3 .* has no Jacobian instantiation"),
    ("f64", "float32's alone, got torch.float64"),
    ("3ang", "sweeps one angle, got n_gauss_angles=3"),
    ("36g", "one g-chunk .* 36 take the pairs layout"),
    ("gases", "shipped lw_fsck \\+ sw_wide shapes"),
])
def test_kernel_refusal_names_what_the_jacobian_leaves_out(models, case,
                                                            match):
    b = make(60, torch.float32)
    kw = dict(k3=dict(kernel="lw"), f64=dict(dtype=torch.float64),
              **{"3ang": dict(n_ang=3), "36g": dict(lw="lw_rrtmgp")},
              gases=dict(gases=("h2o", "o3", "co2", "ch4", "o2")))[case]
    reason = refusal(models, b, **kw)
    assert reason is not None and re.search(match, reason), reason
    # Without the flag the same call is refused only for its CPU tensors.
    assert pipeline._kernel_refusal(b["tlay"], True, 1, (), "lwsw") == \
        "tensors are on cpu, not a CUDA device"
    # On the auto route the torch path answers.
    lw, _ = pipeline.lw_sw_fluxes(
        models["lw_fsck", torch.float32], models["sw_wide", torch.float32],
        b["plev"], b["tlay"], b["tlev"], b["tsfc"], b["emis"],
        solve.gas_concs(b), b["alb"], b["tsi"], b["sza"], flux_up_jac=True)
    assert lw.flux_up_jac is not None


def test_the_shipped_shapes_pass_on_the_cpu_until_the_device_check(models):
    b = make(60, torch.float32)
    assert refusal(models, b) == "tensors are on cpu, not a CUDA device"
    with pytest.raises(ValueError, match="backend='cuda' requested but the "
                       "merged kernel K1"):
        pipeline.lw_sw_fluxes(
            models["lw_fsck", torch.float64], models["sw_wide",
                                                     torch.float64],
            *(b[k].double() for k in ("plev", "tlay", "tlev", "tsfc",
                                      "emis")),
            solve.gas_concs(make(60)), *(b[k].double() for k in (
                "alb", "tsi", "sza")), backend="cuda", flux_up_jac=True)


def test_the_jacobians_routes_at_an_h100():
    """Whole columns (two blocks of 512 to nlay 61, one of 1024 with C = 2
    to 122, C = 1 from 208), split (123-207; the stage to 174): taken; the
    device slice from nlay 246: refused."""
    (lw, gl), (sw, gs) = SHIPPED["lw"], SHIPPED["sw"]
    ok = lambda n: staged.jac_refusal(n, lw, sw, gl, gs, 6, *H100)
    routes = {}
    blocks, slots, sets = staged.SHAPES["lwsw"]
    for n in range(1, 260):
        p = staged.stage_plan(n, lw, sw, 1, gl, gs, *H100,
                              blocks_per_sm=blocks, max_slots=slots,
                              sets=sets, jac=True)
        routes.setdefault((p.route, p.slots, p.threads, p.prm_stage),
                          []).append(n)
        assert (ok(n) is None) == (p.route != "device"), n
    span = {k: (v[0], v[-1]) for k, v in routes.items()}
    assert span == {("shared", 2, 512, True): (1, 61),
                    ("shared", 2, 1024, True): (62, 122),
                    ("split", 2, 1024, True): (123, 174),
                    ("split", 2, 1024, False): (175, 207),
                    ("shared", 1, 1024, False): (208, 245),
                    ("device", 2, 512, False): (246, 259)}
    assert "device slice" in ok(246)
    # Without the card's limits only the shapes are judged.
    assert staged.jac_refusal(400, lw, sw, gl, gs, 6) is None
    assert "6 temperatures" in staged.jac_refusal(91, lw, sw, gl, gs, 5)


def all_plans(**kw):
    """stage_plan over nlay 1-400, the five band widths, the three
    kernels, 1-4 angles and both word sizes, at an H100's limits."""
    for (lw, sw), gl, gs in BANDS:
        for kernel, (ngl, ngs) in (("lwsw", (lw, sw)), ("lw", (lw, 0)),
                                   ("sw", (0, sw))):
            blocks, slots, sets = staged.SHAPES[kernel]
            for word in (4, 8):
                for ang in (1, 2, 3, 4):
                    for nlay in range(1, 401):
                        yield nlay, staged.stage_plan(
                            nlay, ngl, ngs, ang, gl if ngl else (0, 0),
                            gs if ngs else (0, 0), *H100,
                            blocks_per_sm=blocks, max_slots=slots,
                            sets=sets, word_bytes=word, **kw)


def test_stage_plan_without_the_flag_is_the_one_before():
    h = hashlib.sha256()
    n = 0
    for _, p in all_plans():
        h.update(repr(p).encode())
        n += 1
    assert (n, h.hexdigest()) == (48000, PARENT_PLANS)


def test_stage_plan_with_the_flag_adds_a_row_a_slot():
    """Each plan's accumulators grow by (nlay + 1) words; where the plan
    keeps its shape, nothing else changes but the parameters' own place,
    which follows the accumulators."""
    same = 0
    for (nlay, p), (_, q) in zip(all_plans(), all_plans(jac=True)):
        if q.lw_warps != p.lw_warps:
            # The row moves a plan of a band in two g-chunks across a
            # bound of one LW sweep warp a chunk (such bands the Jacobian
            # refuses in any case).
            assert q.lw_floats // nlay // 3 > 32
            continue
        assert q.acc_floats == p.acc_floats + nlay + 1
        shape = lambda x: (x.route, x.slots, x.sets, x.threads,
                           x.prm_stage, x.lw_warps)
        if shape(p) == shape(q) and q.prm_floats == p.prm_floats:
            same += 1
            own = p.prm_floats and p.prm_base >= p.acc_floats
            assert q == dataclasses.replace(
                p, acc_floats=q.acc_floats,
                prm_base=p.prm_base + (nlay + 1 if own else 0))
    assert same > 0.95 * 48000
    # nlay 91 at lw_fsck + sw_wide: 85,772 -> 86,140 B a column, the plan
    # otherwise the same; nlay 60: 56,876 B, two blocks of 512.
    blocks, slots, sets = staged.SHAPES["lwsw"]
    plan91 = lambda **kw: staged.stage_plan(
        91, 32, 27, 1, (7, 1), (5, 1), *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets, **kw)
    assert (plan91().bytes_per_column,
            plan91(jac=True).bytes_per_column) == (85772, 86140)
    assert plan91(jac=True).report == plan91().report == (
        "shared, C = 2, S = 2, 1024 threads, 1 blocks and 2 columns per SM, "
        "stage on")
    p60 = staged.stage_plan(60, 32, 27, 1, (7, 1), (5, 1), *H100,
                            blocks_per_sm=blocks, max_slots=slots,
                            sets=sets, jac=True)
    assert (p60.bytes_per_column, p60.threads, p60.sm_blocks) == (56876, 512,
                                                                  2)


def c_fields(struct: str, source: str):
    src = (CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    return [re.sub(r"\[.*\]", "", line.split()[-1].rstrip(";")).lstrip("*")
            for line in body.splitlines()
            if line.strip() and not line.strip().startswith("//")
            and line.strip().endswith(";")]


def test_the_jacobians_args_mirror_the_c_struct():
    args = binding.LwswJacArgs
    assert [f for f, _ in args._fields_] == c_fields("LwswJacArgs",
                                                     "lwsw.cu")
    assert [f for f, _ in args._fields_][:-1] == [
        f for f, _ in binding.LwswArgs._fields_]
    for mode in ("exact", "fast"):
        assert binding.args_type("lwsw", mode, jac=True) is args
    assert binding.JAC == ("_jac", "jac_launches")
    assert binding.MODES.keys() == {"exact", "fast", "f64"}
    assert [binding.launch_suffix("lwsw", m, jac=True)
            for m in ("exact", "fast")] == ["_jac", "_jac_fast"]
    assert binding.launch_suffixes("lwsw") == (
        "", "_fast", "_f64", "_jac", "_jac_fast")
    assert binding.args_structs("lwsw")["_jac"] is args
    for name, mode in (("lwsw", "f64"), ("lw", "exact"), ("sw", "fast")):
        with pytest.raises(ValueError, match="merged kernel's"):
            binding.launch_suffix(name, mode, jac=True)
    for name in ("lw", "sw"):
        assert binding.launch_suffixes(name) == ("", "_fast")
        assert "_jac" not in binding.args_structs(name)


def _stub(monkeypatch, calls):
    import contextlib

    def entry(suffix):
        return lambda args, stream: calls.append((suffix, args._obj)) or 0
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    return types.SimpleNamespace(**{
        f"ecckd_lwsw_launch{suffix}": entry(suffix)
        for suffix in binding.launch_suffixes("lwsw")})


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_jacobian_launches_count_in_their_own_counter(monkeypatch, mode):
    calls = []
    lib = _stub(monkeypatch, calls)
    before = dict(launches=5, fast_launches=7, f64_launches=9,
                  jac_launches=11)
    counted = types.SimpleNamespace(**before)
    binding.launch_chunks("lwsw", 1037, 512,
                          lambda c0, c1: binding.LwswJacArgs(), counted,
                          None, mode, lib, jac=True)
    assert [m for m, _ in calls] == [binding.launch_suffix("lwsw", mode,
                                                           jac=True)] * 3
    assert vars(counted) == dict(before, jac_launches=14)


@pytest.mark.parametrize("fast", [False, True])
def test_run_staged_hands_the_jacobian_its_output_and_plan(
        monkeypatch, models, fast):
    calls = []
    lib = _stub(monkeypatch, calls)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132,
                            shared_memory_per_block_optin=H100[0],
                            shared_memory_per_multiprocessor=H100[1]))
    monkeypatch.setattr(staged, "blocks_per_sm", lambda *a: 1)
    b = make(91, torch.float32, ncol=37)
    lw_m, sw_m = (models[k, torch.float32] for k in ("lw_fsck", "sw_wide"))
    emis = b["emis"][:, None].expand(37, lw_m.ngpt).contiguous()
    atm, lw_in, sw_in = plan.prepare(
        lw_m, sw_m, b["plev"], b["tlay"], b["tlev"], b["tsfc"], emis,
        solve.gas_concs(b), b["alb"], b["tsi"], b["sza"], 1, fast)
    p = staged.plan_for(atm, lw_in, sw_in, jac=True)
    assert p.acc_floats == 5 * 92
    counted = types.SimpleNamespace(launches=0, fast_launches=0,
                                    jac_launches=0)
    outs = staged.run_staged(atm, lw_in, sw_in, 16, counted, lib=lib,
                             jac=True)
    assert len(outs) == 5 and all(o.shape == (37, 92) for o in outs)
    assert [m for m, _ in calls] == ["_jac_fast" if fast else "_jac"] * 3
    for k, (_, args) in enumerate(calls):
        assert type(args) is binding.LwswJacArgs
        assert args.jac == outs[4][16 * k:].data_ptr()
        assert args.lw.up == outs[0][16 * k:].data_ptr()
        assert args.sw.dn == outs[3][16 * k:].data_ptr()
        assert args.tile.col_floats == p.col_floats
    assert vars(counted) == dict(launches=0, fast_launches=0,
                                 jac_launches=3)


def test_the_checked_matrix_reaches_every_jacobian_regime():
    """tools/cuda_sanitize.py's ``CHECKED_JAC`` reaches every staging
    regime the Jacobian instantiation takes at an H100's limits (route,
    C, threads, the stage), and ``run_checked`` runs it by default, with
    the planted faults; chip_smoke.py's reduced matrix holds two."""
    import inspect
    import chip_smoke
    from tools import cuda_sanitize
    blocks, slots, sets = staged.SHAPES["lwsw"]
    regime = lambda n: (lambda p: (p.route, p.slots, p.threads,
                                   p.prm_stage))(staged.stage_plan(
        n, 32, 27, 1, (7, 1), (5, 1), *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets, jac=True))
    every = {regime(n) for n in range(1, 400)
             if staged.jac_refusal(n, 32, 27, (7, 1), (5, 1), 6, *H100)
             is None}
    assert len(every) == 5
    assert {regime(n) for _, n, _ in cuda_sanitize.CHECKED_JAC} == every
    assert {(k, a) for k, _, a in cuda_sanitize.CHECKED_JAC} == {("lwsw", 1)}
    defaults = inspect.signature(cuda_sanitize.run_checked).parameters
    assert defaults["jac_configs"].default is cuda_sanitize.CHECKED_JAC
    assert {(k, a) for k, _, a in chip_smoke.RING_JAC} == {("lwsw", 1)}
    # The checked build's guard words still fit the card.
    from ecckd_tpu_torch.ops.cuda import ring_check
    for _, n, _ in cuda_sanitize.CHECKED_JAC + chip_smoke.RING_JAC:
        g = ring_check.guarded(staged.stage_plan(
            n, 32, 27, 1, (7, 1), (5, 1), *H100, blocks_per_sm=blocks,
            max_slots=slots, sets=sets, jac=True))
        assert g.shared_bytes <= H100[0], n
        assert g.sm_blocks * (g.shared_bytes + 1024) <= H100[1], n
