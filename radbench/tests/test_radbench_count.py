"""The frozen count against chip_smoke.kernel_bound on the program's own
prepared inputs."""
from radbench import count, inputs, run, solve


def test_frozen_count_reproduces_kernel_bound(tmp_path):
    """51.4 G operations and 162 MB at 65,536 x 60 on the synthetic files,
    exactly as chip_smoke.kernel_bound counts them."""
    import chip_smoke
    from ecckd_tpu_torch.ops.cuda import plan
    _, config = run.load_cell("l60_batch")
    paths = solve.write_ckd_files(config, str(tmp_path))
    ncol, nlay = 65536, 60
    b = inputs.make_batch(ncol, nlay, inputs.generator(1, "cpu"), "cpu")
    lw_m, sw_m = solve.load_models(paths, "cpu")
    emis = b["emis"][:, None].expand(ncol, lw_m.ngpt)
    prep = plan.prepare(lw_m, sw_m, b["plev"], b["tlay"], b["tlev"],
                        b["tsfc"], emis, solve.gas_concs(b), b["alb"],
                        b["tsi"], b["sza"], 1)
    bound = chip_smoke.kernel_bound(prep)
    lw, sw = solve.read_reference_ckd(paths)
    work = count.lwsw_work(lw, sw, solve.gas_sizes(b), ncol, nlay, 1)
    assert work["ops"] == bound["ops"]
    assert work["bytes"] == bound["bytes"]
    assert round(work["ops"] / 1e9, 1) == 51.4
    assert round(work["bytes"] / 1e6) == 162
    assert abs(1e3 * count.least_seconds(work) - bound["bound_ms"]) < 1e-12
    assert bound["bound_by"] == "operations"


def test_count_scales_with_columns_layers_and_angles(tmp_path):
    _, config = run.load_cell("l60_batch")
    lw, sw = solve.read_reference_ckd(
        solve.write_ckd_files(config, str(tmp_path)))
    b = inputs.make_batch(4, 60, inputs.generator(1, "cpu"), "cpu")
    gases = solve.gas_sizes(b)
    one = count.lwsw_work(lw, sw, gases, 1000, 60, 1)
    assert count.lwsw_work(lw, sw, gases, 2000, 60, 1)["ops"] == 2 * one["ops"]
    assert count.lwsw_work(lw, sw, gases, 1000, 137, 1)["ops"] > 2 * one["ops"]
    assert count.lwsw_work(lw, sw, gases, 1000, 60, 3)["ops"] > one["ops"]
