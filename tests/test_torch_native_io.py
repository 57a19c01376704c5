"""PyTorch port: the native netCDF3 engine (io/nc3_native.py) against scipy.

The port's counterparts of tests/test_native_io.py's nine cases, on
synthetic ckd and RFMIP files (the shipped files are not in the
repository): reader against scipy, the units attribute, the writer's
round trip, the template fill, the ckd loader native == scipy bit for bit,
an unwritten variable refused, a truncated header refused, the streaming
``numrecs`` sentinel and an unknown type that fails loudly.

Then the RFMIP drivers: their files are the same bit for bit under both
engines (scipy forced by making ``load_library`` return None, as the JAX
test does) and match the JAX drivers' at rtol <= 1e-10 (f64); and the
engine builds into ``ecckd_tpu_torch/_build/`` without touching
``native/build/``.
"""
import json
import os
import struct
import threading

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from torch_parity import KINDS, ckd_paths  # noqa: F401
from ecckd_tpu.cli import (ecckd_rfmip_lw as j_lw,
                           ecckd_rfmip_sw as j_sw)
from ecckd_tpu.io import rfmip as jrfmip
from ecckd_tpu_torch.cli import (ecckd_rfmip as t_lwsw,
                                 ecckd_rfmip_lw as t_lw,
                                 ecckd_rfmip_sw as t_sw)
from ecckd_tpu_torch.io import nc3_native
from ecckd_tpu_torch.io import rfmip as trfmip
from ecckd_tpu_torch.models import loader

torch.set_num_threads(2)
STEM = "_Efx_RTE-ecckd_rad-irf_r1i1p{p}f1_gn.nc"


@pytest.fixture
def nc3():
    assert nc3_native.load_library() is not None
    return nc3_native


@pytest.fixture
def scipy_only(monkeypatch):
    """The engine as if it could not be built here."""
    monkeypatch.setattr(nc3_native, "load_library", lambda: None)


def _text(x):
    return x.decode() if isinstance(x, bytes) else x


@pytest.mark.parametrize("key", ["lw", "sw", "lw_rrtmgp"])
def test_reader_matches_scipy(ckd_paths, nc3, key):
    path = ckd_paths[key]
    ref = netcdf_file(path, mmap=False)
    with nc3.NativeReader(path) as r:
        assert r.dimensions == dict(ref.dimensions)
        assert set(r.var_names) == set(ref.variables)
        for name, var in ref.variables.items():
            want = np.asarray(var.data)
            np.testing.assert_array_equal(r.read(name),
                                          want.astype(np.float64), name)
            got = r.read_exact(name)
            assert got.dtype == want.dtype.newbyteorder("="), name
            np.testing.assert_array_equal(got, want, name)
        for att in ("constituent_id", "composite_constituent_id"):
            if hasattr(ref, att):
                assert r.att_text(None, att) == _text(getattr(ref, att))
        assert r.att_text(None, "no_such_attribute") is None
        with pytest.raises(KeyError):
            r.read("no_such_variable")
    ref.close()


def test_reader_var_units_attribute(tmp_path, nc3):
    p = str(tmp_path / "rfmip.nc")
    trfmip.write_synthetic_rfmip(p, nsite=7, nlay=13, nexp=2)
    ref = netcdf_file(p, mmap=False)
    with nc3.NativeReader(p) as r:
        for name, var in ref.variables.items():
            np.testing.assert_array_equal(
                r.read(name), np.asarray(var.data).astype(np.float64), name)
            units = getattr(var, "units", None)
            if units is not None:
                assert r.att_text(name, "units") == _text(units)
    ref.close()


def test_writer_roundtrip(tmp_path, nc3):
    p = str(tmp_path / "out.nc")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 4))
    b = rng.standard_normal((5,)).astype(np.float32)
    w = nc3.NativeWriter(p)
    for name, size in (("x", 3), ("y", 5), ("z", 4)):
        w.def_dim(name, size)
    w.def_var("a", "d", ("x", "y", "z"))
    w.def_var("b", "f", ("y",))
    w.put_att("a", "units", "W m-2")
    w.put_att(None, "title", "roundtrip")
    w.put_var("a", a)
    w.put_var("b", b)
    w.finish()
    f = netcdf_file(p, mmap=False)
    np.testing.assert_array_equal(np.asarray(f.variables["a"].data), a)
    np.testing.assert_array_equal(np.asarray(f.variables["b"].data), b)
    assert _text(f.variables["a"].units) == "W m-2"
    f.close()
    with nc3.NativeReader(p) as r:
        np.testing.assert_array_equal(r.read("a"), a)
        assert r.read_exact("b").dtype == np.float32
        assert r.att_text(None, "title") == "roundtrip"


def test_update_var_template_fill(tmp_path, nc3):
    """In-place overwrite, the reference's CMIP-template fill
    (mo_rfmip_io.F90:288-317), into a float32 variable."""
    p = str(tmp_path / "tmpl.nc")
    w = nc3.NativeWriter(p)
    for name, size in (("expt", 2), ("site", 3), ("level", 4)):
        w.def_dim(name, size)
    w.def_var("rlu", "f", ("expt", "site", "level"))
    w.put_var("rlu", np.zeros((2, 3, 4)))
    w.finish()
    data = np.arange(24, dtype=np.float64).reshape(2, 3, 4) / 7.0
    nc3.update_var(p, "rlu", data)
    f = netcdf_file(p, mmap=False)
    np.testing.assert_array_equal(np.asarray(f.variables["rlu"].data),
                                  data.astype(np.float32))
    f.close()
    with pytest.raises(OSError):
        nc3.update_var(p, "no_such_variable", data)


@pytest.mark.parametrize("key", sorted(KINDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ckd_loader_native_matches_scipy(ckd_paths, nc3, monkeypatch, key,
                                         dtype):
    """load_ckd_model gives the same model bit for bit whichever engine
    parses the file: tables, grids, Planck/solar arrays and the static
    metadata, grid_key (a content hash) included."""
    m_native = loader.load_ckd_model(ckd_paths[key], dtype=dtype)
    monkeypatch.setattr(nc3_native, "load_library", lambda: None)
    assert trfmip.io_engine() == "scipy"
    m_scipy = loader.load_ckd_model(ckd_paths[key], dtype=dtype)
    for name, a in vars(m_native).items():
        b = getattr(m_scipy, name)
        if name == "_cache":
            continue
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        elif isinstance(a, tuple) and a and isinstance(a[0], torch.Tensor):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        else:
            assert a == b, name
    assert m_native.grid_key == m_scipy.grid_key


def test_writer_rejects_unwritten_variable(tmp_path, nc3):
    """finish() refuses a defined variable that was never written (its
    begin offset would alias the next variable's data)."""
    w = nc3.NativeWriter(str(tmp_path / "alias.nc"))
    w.def_dim("x", 4)
    w.def_var("a", "d", ("x",))
    w.def_var("b", "d", ("x",))
    w.put_var("b", np.arange(4.0))
    with pytest.raises(OSError, match="never written"):
        w.finish()


def test_reader_rejects_truncated_header(tmp_path, nc3):
    """Every cut inside the header fails with a clean OSError."""
    good = str(tmp_path / "good.nc")
    w = nc3.NativeWriter(good)
    w.def_dim("x", 8)
    w.def_var("long_variable_name_to_cut_through", "d", ("x",))
    w.put_var("long_variable_name_to_cut_through", np.arange(8.0))
    w.put_att(None, "title", "truncate me")
    w.finish()
    blob = open(good, "rb").read()
    for cut in range(5, min(len(blob) - 65, 200), 7):
        bad = str(tmp_path / f"cut{cut}.nc")
        with open(bad, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(OSError):
            nc3.NativeReader(bad)


def test_reader_streaming_numrecs_sentinel(tmp_path, nc3):
    """numrecs == 0xFFFFFFFF (STREAMING) is derived from the file size."""
    p = str(tmp_path / "rec.nc")
    f = netcdf_file(p, "w")
    f.createDimension("t", None)
    f.createDimension("x", 3)
    v = f.createVariable("v", "f8", ("t", "x"))
    v[0] = [1.0, 2.0, 3.0]
    v[1] = [4.0, 5.0, 6.0]
    f.flush()
    f.close()
    blob = bytearray(open(p, "rb").read())
    blob[4:8] = b"\xff\xff\xff\xff"
    p2 = str(tmp_path / "stream.nc")
    open(p2, "wb").write(bytes(blob))
    with nc3.NativeReader(p2) as r:
        assert r.var_shape("v") == (2, 3)
        np.testing.assert_array_equal(r.read("v"), [[1.0, 2.0, 3.0],
                                                    [4.0, 5.0, 6.0]])


def test_reader_unknown_type_is_loud(tmp_path, nc3):
    u32 = lambda v: struct.pack(">I", v)
    hdr = b"CDF\x01" + u32(0)
    hdr += u32(0x0A) + u32(1) + u32(1) + b"x\x00\x00\x00" + u32(2)
    hdr += u32(0) + u32(0)
    hdr += u32(0x0B) + u32(1) + u32(1) + b"v\x00\x00\x00"
    hdr += u32(1) + u32(0) + u32(0) + u32(0)
    hdr += u32(99) + u32(16) + u32(len(hdr) + 8)
    p = str(tmp_path / "badtype.nc")
    open(p, "wb").write(hdr + struct.pack(">2d", 1.5, 2.5))
    with nc3.NativeReader(p) as r:
        with pytest.raises(OSError, match="unknown type"):
            r.read("v")


@pytest.fixture(scope="module")
def rfmip_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rfmip_io") / "rfmip.nc")
    jrfmip.write_synthetic_rfmip(path, nsite=6, nlay=16, nexp=2, seed=4)
    return path


def _drive(main, args, out_dir, extra=()):
    metrics = os.path.join(str(out_dir), "metrics.json")
    assert main([*args, "--output-dir", str(out_dir), "--precision", "f64",
                 "--heating-rates", "--metrics-json", metrics, *extra]) == 0
    return metrics


def _read_scipy(out_dir, var, p):
    f = netcdf_file(os.path.join(str(out_dir), var + STEM.format(p=p)),
                    mmap=False)
    data = np.array(f.variables[var].data)
    f.close()
    return data


@pytest.mark.parametrize("driver", ["lw", "sw", "lwsw"])
def test_cli_files_equal_under_both_engines_and_match_jax(
        rfmip_file, ckd_paths, tmp_path, monkeypatch, driver):
    ckd = {"lw": [ckd_paths["lw"]], "sw": [ckd_paths["sw"]],
           "lwsw": [ckd_paths["lw"], ckd_paths["sw"]]}[driver]
    main = {"lw": t_lw.main, "sw": t_sw.main, "lwsw": t_lwsw.main}[driver]
    lw_vars = [("rlu", 2), ("rld", 2), ("hrl", 2)]
    sw_vars = [("rsu", 1), ("rsd", 1), ("hrs", 1)]
    outputs = {"lw": lw_vars, "sw": sw_vars, "lwsw": lw_vars + sw_vars}[
        driver]
    args = [rfmip_file, *ckd, "-p", "2", "--device", "cpu"]
    m_native = _drive(main, args, tmp_path / "native")
    with monkeypatch.context() as mp:
        mp.setattr(nc3_native, "load_library", lambda: None)
        m_scipy = _drive(main, args, tmp_path / "scipy")
    for path, engine in ((m_native, "native"), (m_scipy, "scipy")):
        with open(path) as f:
            assert json.load(f)["io_engine"] == engine
    # A second native run into the same directory fills the files in
    # place (update_var): still the same bits.
    _drive(main, args, tmp_path / "native")
    if driver != "sw":
        _drive(j_lw.main, [rfmip_file, ckd_paths["lw"], "-p", "2"],
               tmp_path / "jax", ["--no-shard"])
    if driver != "lw":
        _drive(j_sw.main, [rfmip_file, ckd_paths["sw"]], tmp_path / "jax",
               ["--no-shard"])
    for var, p in outputs:
        native = _read_scipy(tmp_path / "native", var, p)
        assert native.dtype == np.dtype(">f8") and np.isfinite(native).all()
        np.testing.assert_array_equal(native,
                                      _read_scipy(tmp_path / "scipy", var, p))
        np.testing.assert_allclose(native, _read_scipy(tmp_path / "jax", var,
                                                       p),
                                   rtol=1e-10, atol=0, err_msg=var)


def test_read_rfmip_same_under_both_engines(rfmip_file, nc3, monkeypatch):
    native = trfmip.read_rfmip(rfmip_file, 2)
    monkeypatch.setattr(nc3_native, "load_library", lambda: None)
    scipy = trfmip.read_rfmip(rfmip_file, 2)
    for name in ("play", "plev", "tlay", "tlev", "sfc_emis", "sfc_t",
                 "sfc_alb", "tsi", "sza"):
        a, b = getattr(native, name), getattr(scipy, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, name)
    for field in ("gases_3d", "gases_scalar"):
        for k, v in getattr(native, field).items():
            np.testing.assert_array_equal(v, getattr(scipy, field)[k], k)


def test_engine_builds_into_the_package(tmp_path, nc3, monkeypatch):
    """The engine is built from native/ecckd_io's sources into
    ecckd_tpu_torch/_build/ under a keyed name; native/build/ is neither
    an input nor an output, and concurrent builds land one file."""
    lib = nc3.load_library()
    path = nc3.library_path()
    assert lib._name == str(path)
    assert path.parent == nc3.BUILD_DIR
    assert nc3.BUILD_DIR.parent.name == "ecckd_tpu_torch"
    assert path.name.startswith("libecckd_io-") and path.is_file()
    assert nc3.CXX_FLAGS == ("-O2", "-std=c++17", "-fPIC", "-shared")
    commands = []
    real_run = nc3_native.subprocess.run

    def spy(cmd, **kw):
        commands.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(nc3_native.subprocess, "run", spy)
    monkeypatch.setattr(nc3_native, "BUILD_DIR", tmp_path / "_build")
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        nc3_native.build(nc3_native.compiler()))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 3 and len(set(out)) == 1
    assert sorted(os.listdir(tmp_path / "_build")) == [out[0].name]
    assert out[0].name == path.name
    assert commands
    for cmd in commands:
        assert not any("native/build" in str(a) for a in cmd)
        target = cmd[cmd.index("-o") + 1]
        assert os.path.dirname(target) == str(tmp_path / "_build")
        assert [os.path.basename(a) for a in cmd[-2:]] == ["nc3.cc",
                                                           "nc3_capi.cc"]


def test_no_compiler_means_scipy(monkeypatch, tmp_path):
    """Without a C++ compiler the engine is not built and scipy serves;
    the engine in use is named, never hidden."""
    monkeypatch.setattr(nc3_native, "_lib", None)
    monkeypatch.setattr(nc3_native, "compiler", lambda: None)
    assert nc3_native.load_library() is None
    assert trfmip.io_engine() == "scipy"
    with pytest.raises(RuntimeError, match="cannot be built"):
        nc3_native.NativeWriter(str(tmp_path / "x.nc"))
    fluxes = np.random.default_rng(1).uniform(0, 400, (6, 5))
    path = str(tmp_path / "rlu.nc")
    trfmip.write_fluxes(path, "rlu", fluxes, nsite=3, nexp=2)
    trfmip.write_fluxes(path, "rlu", fluxes + 1.0, nsite=3, nexp=2)
    np.testing.assert_array_equal(trfmip.read_fluxes(path, "rlu"),
                                  fluxes + 1.0)
