"""PyTorch port: tools/build_compare.py's reading of two trees' kernel
builds, on ptxas and sass_count reports written here (the builds need
nvcc and run on a card's machine).

Functions are compared one by one: one that the other tree has and this
one lacks, or whose report differs, fails the comparison; one that only
this tree has (a new instantiation) is listed and passes.
"""
from tools import build_compare

ENTRY = "_ZN12_GLOBAL__N__{h}11lwsw_kernelIfLb1EEEvT_"
SPLIT = "_ZN12_GLOBAL__N__{h}17lwsw_split_kernelIfEEvT_"
DEVICE_FN = "_ZN12_GLOBAL__N__{h}12layer_paramsIfEEvv"


def ptxas(h, regs=64, split=False, ms="1.5"):
    text = (
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Function properties for {DEVICE_FN.format(h=h)}\n"
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Compiling entry function '{ENTRY.format(h=h)}' "
        "for 'sm_90a'\n"
        f"ptxas info    : Function properties for {ENTRY.format(h=h)}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 16 barriers, 2048 "
        "bytes cmem[0]\n"
        f"ptxas info    : Compile time = {ms} ms\n")
    if split:
        text += (
            f"ptxas info    : Compiling entry function "
            f"'{SPLIT.format(h=h)}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {SPLIT.format(h=h)}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            "ptxas info    : Used 64 registers, used 16 barriers, 2048 bytes "
            "cmem[0]\n")
    return text


def sass(h, total=900, split=False):
    text = (f"== lwsw {ENTRY.format(h=h)}: 2000 instructions | total={total}"
            " | mufu {}\n   loop 0x10-0x90 depth 0 nested 0: total=9 | "
            "mufu {}\n")
    if split:
        text += (f"== lwsw {SPLIT.format(h=h)}: 2100 instructions | "
                 "total=950 | mufu {}\n")
    return text


def test_equal_builds_compare_equal_across_namespace_hashes():
    got = build_compare.compare(
        build_compare.ptxas_functions(ptxas("deadbeef", ms="3.0")),
        build_compare.ptxas_functions(ptxas("1234abcd")))
    assert got == {"differ": [], "missing": [], "added": []}


def test_an_added_instantiation_is_listed_and_passes():
    got = build_compare.compare(
        build_compare.ptxas_functions(ptxas("deadbeef", split=True)),
        build_compare.ptxas_functions(ptxas("1234abcd")))
    assert got["differ"] == [] and got["missing"] == []
    assert got["added"] == [build_compare.normalize(SPLIT.format(h="0"
                                                                 * 8))]
    s = build_compare.compare(
        build_compare.sass_functions(sass("deadbeef", split=True)),
        build_compare.sass_functions(sass("1234abcd")))
    assert (s["differ"], s["missing"], len(s["added"])) == ([], [], 1)


def test_a_changed_or_lost_function_fails():
    regs = build_compare.compare(
        build_compare.ptxas_functions(ptxas("deadbeef", regs=63)),
        build_compare.ptxas_functions(ptxas("1234abcd")))
    assert regs["differ"] == [build_compare.normalize(
        ENTRY.format(h="1234abcd"))]
    lost = build_compare.compare(
        build_compare.ptxas_functions(ptxas("deadbeef")),
        build_compare.ptxas_functions(ptxas("1234abcd", split=True)))
    assert len(lost["missing"]) == 1
    counts = build_compare.compare(
        build_compare.sass_functions(sass("deadbeef", total=901)),
        build_compare.sass_functions(sass("1234abcd")))
    assert len(counts["differ"]) == 1
