"""README's H100 throughput rows against the committed bench_cuda.py
artifacts (tools/check_cuda_perf_claims.py, the port's counterpart of
tests/test_perf_claims.py); needs no card.

* The committed README and BENCH_CUDA*.json agree.
* In a copy, a README row 20 % off, an artifact whose ``device`` names no
  NVIDIA card, both at once, and an inlined "M cols/s" claim in the
  port's pipeline are each reported.
"""
import json
import os
import re
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import check_cuda_perf_claims  # noqa: E402


def test_committed_claims_match_the_artifacts():
    errors = check_cuda_perf_claims.check()
    assert not errors, "\n".join(errors)


def doctor_row(root):
    """The headline row's columns/s made 20 % larger."""
    path = os.path.join(root, "README.md")
    with open(path) as f:
        readme = f.read()
    row = re.compile(r"(`BENCH_CUDA\.json`[^|\n]*\|\s*~)([\d,]+)")
    value = float(row.search(readme).group(2).replace(",", ""))
    with open(path, "w") as f:
        f.write(row.sub(lambda m: m.group(1) + f"{value * 1.2:,.0f}",
                        readme, count=1))
    return "headline, exact tables columns/s"


def doctor_device(root):
    path = os.path.join(root, "BENCH_CUDA_FAST.json")
    with open(path) as f:
        rec = json.load(f)
    rec["device"] = "Some Accelerator, 700.00 W"
    with open(path, "w") as f:
        json.dump(rec, f)
    return "names no NVIDIA card"


def doctor_source(root):
    os.makedirs(os.path.join(root, "ecckd_tpu_torch"))
    with open(os.path.join(root, "ecckd_tpu_torch", "pipeline.py"),
              "w") as f:
        f.write('"""Runs at 12.5M cols/s on one card."""\n')
    return "inlined 'M cols/s' claim"


@pytest.mark.parametrize("doctors", [
    (doctor_row,), (doctor_device,), (doctor_row, doctor_device),
    (doctor_source,)], ids=["row", "device", "row+device", "source"])
def test_doctored_claims_are_reported(tmp_path, doctors):
    for name in os.listdir(REPO):
        if name == "README.md" or name.startswith("BENCH_CUDA"):
            shutil.copy(os.path.join(REPO, name), tmp_path / name)
    assert check_cuda_perf_claims.check(str(tmp_path)) == []
    expected = [doctor(str(tmp_path)) for doctor in doctors]
    errors = check_cuda_perf_claims.check(str(tmp_path))
    for text in expected:
        assert any(text in e for e in errors), (text, errors)
    assert len(errors) == len(expected)
