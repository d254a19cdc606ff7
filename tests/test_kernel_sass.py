"""`scripts/kernel_sass.py`'s dataflow hash and instantiation names, on
hand-written SASS (no compiler needed)."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "kernel_sass", ROOT / "scripts" / "kernel_sass.py")
KS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(KS)

# a loop body: a 128-bit shared load of the next row, a pair's distance
# from two receiver registers the loop only reads, a predicated select,
# two accumulators carried to the next trip, the back branch
LOOP = """LDS.128 R4, [R8]
FADD R36, R21, -R4.reuse
FADD R39, R26, -R5
FMUL R35, R36, R36
FFMA R35, R39, R39, R35
FSETP.GT.AND P1, PT, R35, RZ, PT
MUFU.RSQ R38, R35
FMUL R40, R6, R38
FSEL R40, R40, RZ, P1
FFMA R34, R36, R40, R34
FFMA R18, R39, R40, R18
IADD3 R8, R8, 0x40, RZ
@!P2 BRA 0xa20""".splitlines()

# the same loop with other registers and independent instructions
# swapped, and the commuting sources of a multiply in the other order
RENAMED = """LDS.128 R12, [R9]
FADD R44, R27, -R13
FADD R40, R23, -R12.reuse
FMUL R37, R40, R40
FFMA R37, R44, R44, R37
MUFU.RSQ R41, R37
FSETP.GT.AND P1, PT, R37, RZ, PT
FMUL R42, R41, R14
FSEL R42, R42, RZ, P1
FFMA R19, R44, R42, R19
FFMA R33, R40, R42, R33
IADD3 R9, R9, 0x40, RZ
@!P2 BRA 0xa30""".splitlines()


def test_dataflow_sha_ignores_allocation_and_order():
    assert KS.dataflow_sha(LOOP) == KS.dataflow_sha(RENAMED)


@pytest.mark.parametrize("line,swap", [
    (7, "FADD R40, R6, R38"),          # another operation
    (3, "FMUL R35, R36, R39"),         # another operand
    (7, "FMUL R40, R7, R38"),          # another lane of the 128-bit load
    (11, "IADD3 R8, R8, 0x80, RZ"),    # another stride
    (9, "FFMA R34, R36, -R40, R34"),   # a sign
])
def test_dataflow_sha_sees_a_changed_computation(line, swap):
    changed = list(LOOP)
    changed[line] = swap
    assert KS.dataflow_sha(changed) != KS.dataflow_sha(LOOP)


def test_instantiation_names_the_template_arguments():
    name = ("_ZN47_GLOBAL__N__fe5e4c86_14_pair_forces_cu_48337b0823"
            "pair_forces_twod_kernelILi256ELb0ELb1ELb0ELb1ELb0EEEvPKiS2_"
            "PKfS4_PfiiifN3csf10TwodParamsEPy")
    assert KS.instantiation(name) == "pair_forces_twod_kernel<256,0,1,0,1,0>"
