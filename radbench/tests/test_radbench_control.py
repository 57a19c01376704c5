"""The control: the program's own path of lower precision, its fast
table mode (bf16 tables and interpolation weights), has to come out as
not correct.

On the card it is the fast entry point of the merged kernel (test marked
``cuda``, which skips without a card; run it there as ``python -m pytest
radbench/tests/test_radbench_control.py -q``).  On the CPU the fast mode's
plain version (``lwsw_fluxes_plain`` with ``mxu_mode="bf16"``), the
kernel's specification, stands in the program's place."""
import pytest
import torch

from radbench import run, solve
from radbench.tests import helpers


def test_fast_plain_version_in_the_programs_place_fails(monkeypatch):
    from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_plain

    def fast_call(self, args):
        lw, sw, plev, tlay, tlev, tsfc, emis, concs, alb, tsi, sza = args
        emis_gpt = emis[:, None].expand(-1, lw.ngpt)
        return lwsw_fluxes_plain(lw, sw, plev, tlay, tlev, tsfc, emis_gpt,
                                 concs, alb, tsi, sza,
                                 n_gauss_angles=self.kwargs["n_gauss_angles"],
                                 mxu_mode="bf16")

    exact = helpers.run_small("l60_batch")
    monkeypatch.setattr(solve.Program, "__call__", fast_call)
    fast = helpers.run_small("l60_batch")
    assert exact["correct"] and not fast["correct"]
    assert (fast["check"]["flux_err_p99"]["value"]
            > 3 * exact["check"]["flux_err_p99"]["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["l60_batch", "l137_batch",
                                  "l60_rfmip_calls"])
def test_fast_mode_on_the_card_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import time
    from ecckd_tpu_torch import config as port_config
    cell, config = helpers.small_cell(name)
    cell["params"].update(ncol=4096, column_chunk=1024,
                          check_columns_per_chunk=8)
    devices = [torch.device("cuda", 0)]
    exact = run.run_cell(name, cell, config, helpers.SEED, 0.5, False,
                         devices, t_start=time.perf_counter())
    port_config.set_mxu_precision("bf16")
    try:
        fast = run.run_cell(name, cell, config, helpers.SEED, 0.5, False,
                            devices, t_start=time.perf_counter())
    finally:
        port_config.set_mxu_precision("bf16x3")
    assert exact["correct"] and not fast["correct"]
