"""README's H100 throughput rows must match the committed bench_cuda.py
artifacts: the port's counterpart of tools/check_perf_claims.py.

Each row of the table in README's port section ("## PyTorch / H100
port") names its artifact in backquotes and gives columns/s and the ratio
to the port's CPU baseline as ``| ~N | ~R× |``:

  headline, exact tables   -> BENCH_CUDA.json          ("value")
  headline, fast tables    -> BENCH_CUDA_FAST.json     ("value")
  merged LW+SW, 3 angles   -> BENCH_CUDA_CONFIGS.json  (lw_fsck+sw_wide_3ang)

Both numbers must lie within 10 % of the artifact's.  Each artifact must
be gated (``"parity_ok": true``) and name an NVIDIA card in ``"device"``,
and README's port section must name that card and power limit.  The
port's user-facing sources (``ecckd_tpu_torch/cli/*.py``, ``pipeline.py``,
``__init__.py``, ``utils/capture.py``) carry no inlined "% faster" or
"M cols/s" claims: they drift silently; the artifacts are the record.

    python tools/check_cuda_perf_claims.py      # exit 1 on any drift

Run by tests/test_torch_perf_claims.py; needs no card and imports nothing
of JAX.
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 0.10
SECTION = "## PyTorch / H100 port"

# artifact -> (what the row claims, the case in a configs artifact)
ROWS = {"BENCH_CUDA.json": ("headline, exact tables", None),
        "BENCH_CUDA_FAST.json": ("headline, fast tables", None),
        "BENCH_CUDA_CONFIGS.json": ("merged LW+SW, 3 angles",
                                    "lw_fsck+sw_wide_3ang")}

CLAIM_PATTERNS = ((r"~?\d+(?:\.\d+)?%\s+faster", "'% faster'"),
                  (r"~?\d+(?:\.\d+)?M\s+col(?:umn)?s?/s", "'M cols/s'"))


def _number(text: str) -> float:
    return float(text.replace(",", ""))


def check(root: str = REPO) -> list:
    """Every drift found under ``root`` (README.md, the artifacts and the
    port's user-facing sources), as messages; empty when all agree."""
    errors = []
    with open(os.path.join(root, "README.md")) as f:
        readme = f.read()
    at = readme.find(SECTION)
    if at < 0:
        return [f"README.md has no {SECTION!r} section"]
    section = readme[at:]

    for artifact, (label, case) in ROWS.items():
        path = os.path.join(root, artifact)
        if not os.path.exists(path):
            errors.append(f"{artifact} missing: the README row '{label}' "
                          "has no backing artifact")
            continue
        with open(path) as f:
            rec = json.load(f)
        device = rec.get("device", "")
        if "NVIDIA" not in device:
            errors.append(f"{artifact}: device {device!r} names no NVIDIA "
                          "card")
        elif device not in section:
            errors.append(f"{artifact}: README's port section does not name "
                          f"its card and power limit {device!r}")
        if rec.get("parity_ok") is not True:
            errors.append(f"{artifact} is not parity-gated "
                          "(parity_ok is not true)")
        value = rec["configs"][case] if case else rec["value"]
        ratio = rec["vs_baseline"][case] if case else rec["vs_baseline"]
        m = re.search(r"`" + re.escape(artifact) + r"`[^|\n]*\|\s*~([\d,.]+)"
                      r"\s*\|\s*~([\d,.]+)\s*×", section)
        if not m:
            errors.append(f"README row for {artifact} ('{label}': "
                          "| ~columns/s | ~ratio× |) not found")
            continue
        for what, claimed, measured in (
                ("columns/s", _number(m.group(1)), value),
                ("vs CPU baseline", _number(m.group(2)), ratio)):
            if measured <= 0 or abs(claimed - measured) / measured > TOL:
                errors.append(
                    f"{label} {what}: README claims ~{claimed:,.1f} but "
                    f"{artifact} measured {measured:,.1f} (> {TOL:.0%} "
                    "apart): update the README from the artifact")

    port = os.path.join(root, "ecckd_tpu_torch")
    surface = (glob.glob(os.path.join(port, "cli", "*.py"))
               + [os.path.join(port, name) for name in (
                   "pipeline.py", "__init__.py",
                   os.path.join("utils", "capture.py"))])
    for path in sorted(surface):
        if not os.path.exists(path):
            continue
        with open(path) as f:
            src = f.read()
        for pattern, what in CLAIM_PATTERNS:
            if re.search(pattern, src):
                errors.append(f"{os.path.relpath(path, root)} carries an "
                              f"inlined {what} claim; cite the "
                              "BENCH_CUDA*.json artifacts instead")
    return errors


def main() -> int:
    errors = check()
    for e in errors:
        print(f"DRIFT: {e}", file=sys.stderr)
    if not errors:
        print("cuda perf claims: OK (README's H100 rows match the "
              "BENCH_CUDA*.json artifacts; no inlined claims)")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
