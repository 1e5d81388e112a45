#!/usr/bin/env python3
"""SASS instructions per path-step of the Monte Carlo kernels, by pipe.

    PYTHONPATH=src python3 tools/sass_pipes.py [--sass FILE] [--listing FILE]

Builds ``src/repro_torch/kernels/csrc/mc_paths.cu`` (or reads a saved
``cuobjdump -sass`` listing with ``--sass``), finds each kernel's step loop
(the innermost backward branch whose body holds the expf's ``MUFU.EX2``,
one a step), and counts the instructions of its body by the pipe that
issues them, per path-step. Code of the body that a step does not run
(slow paths: calls, local memory, double precision, nested loops, such as
the Payne-Hanek reduction of sincosf for huge arguments) is skipped.

From the counts it gives each pipe's issue cycles per warp and step on one
SM sub-partition of an H100 and the least time a launch needs at the SM
clock ``--mhz`` (default: ``nvidia-smi``'s clocks.max.sm). Throughputs per
SM and clock, from the CUDA programming guide's table for compute
capability 9.0: FP32 add, multiply and fma 128; integer add, logic, shift,
compare, min and max 64 (the ALU pipe, 16 lanes a sub-partition); integer
multiply-add 64 (IMAD, on the half of the FMA pipe that also takes FP32);
MUFU and the XU's conversions 16; and one instruction of any kind issues
per sub-partition and clock.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# opcode categories: fp32, int (ALU pipe, and IMAD on the FMA pipe), mufu, conversion
FP32 = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I"}
IMAD = {"IMAD", "IMUL", "IMUL32I", "IMAD32I"}
INT = {"IADD3", "IADD", "IADD32I", "VIADD", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
       "SHR", "LEA", "ISETP", "IMNMX", "VIMNMX", "IABS", "SEL", "PRMT", "BMSK",
       "BREV", "FLO", "POPC", "SGXT", "PLOP3", "FSETP", "FMNMX", "FSEL", "FSET",
       "FCHK", "ISET", "P2R", "R2P"} | IMAD
# conversions: I2FP/F2IP run on the ALU pipe, the older forms on the XU
ALU_CONVERSION = {"I2FP", "F2IP"}
XU_CONVERSION = {"I2F", "F2I", "F2F", "FRND", "I2I"}
SMSP_PER_SM = 4
THREADS_PER_WARP = 32
SLOW = {"CALL", "STL", "LDL", "DMUL", "DADD", "DFMA"}

INSN = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(?:(@!?U?P[T0-9]+)\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
TARGET = re.compile(r"\b0x([0-9a-f]+)\b")


def pipe_of(opcode: str) -> str:
    """The category of an opcode: fp32, int, mufu, conversion or
    other (moves, branches, loads, uniform-datapath work)."""
    base = opcode.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base in FP32:
        return "fp32"
    if base in INT:
        return "int"
    if base in ALU_CONVERSION | XU_CONVERSION:
        return "conversion"
    return "other"


def issue_cycles(ops: Counter, steps: int) -> dict[str, float]:
    """Cycles per warp and step on one sub-partition that each pipe, and
    the issue slot, needs for the opcodes ``ops`` of ``steps`` steps."""
    def n(pred) -> float:
        return sum(c for op, c in ops.items() if pred(op.split(".")[0], op)) / steps

    alu = n(lambda b, op: (b in INT and b not in IMAD) or b in ALU_CONVERSION)
    imad = n(lambda b, op: b in IMAD)
    fp32 = n(lambda b, op: b in FP32)
    xu = n(lambda b, op: b == "MUFU" or b in XU_CONVERSION)
    return {
        "alu": 2 * alu,                      # 16 lanes: a warp in 2 cycles
        "fma": max(fp32 + imad, 2 * imad),   # 32 lanes for FP32, 16 for IMAD
        "xu": 8 * xu,                        # 4 lanes: a warp in 8 cycles
        "issue": sum(ops.values()) / steps,  # one instruction a cycle
    }


def parse(sass: str) -> dict[str, list[dict]]:
    """Instructions of each function: address, guard, opcode, operands and,
    for a branch, its target address (cuobjdump prints targets as
    addresses)."""
    funcs: dict[str, list[dict]] = {}
    cur = None
    for line in sass.splitlines():
        m = FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = INSN.match(line)
        if m and cur is not None:
            target = TARGET.search(m.group(4))
            is_branch = m.group(3).split(".")[0] in ("BRA", "BRX", "JMP")
            cur.append(dict(addr=int(m.group(1), 16), guard=m.group(2), op=m.group(3),
                            args=m.group(4),
                            target=int(target.group(1), 16) if is_branch and target else None))
    return funcs


def step_loop(insns: list[dict]):
    """(first, last) indices of the innermost loop that holds MUFU.EX2 and,
    among those, the one with the most; None if there is none."""
    index = {ins["addr"]: k for k, ins in enumerate(insns)}
    loops = []
    for k, ins in enumerate(insns):
        t = ins["target"]
        if t is not None and t <= ins["addr"] and t in index:
            loops.append((index[t], k))

    def ex2(span):
        return sum(insns[i]["op"].startswith("MUFU.EX2") for i in range(span[0], span[1] + 1))

    with_ex2 = [lp for lp in loops if ex2(lp)]
    inner = [lp for lp in with_ex2
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in with_ex2)]
    return max(inner, key=ex2) if inner else None


def hot_path(insns: list[dict], first: int, last: int) -> tuple[list[int], list[int]]:
    """Split the loop body into the instructions a step runs and the cold
    ones, by walking it from its head: an unconditional forward branch is
    followed; a guarded one is taken when the code it jumps over holds a
    slow path (a call, local memory, double precision or a nested loop),
    the fall-through otherwise. Guarded instructions count as run."""
    index = {ins["addr"]: k for k, ins in enumerate(insns)}

    def slow(lo: int, hi: int) -> bool:
        return any(insns[i]["op"].split(".")[0] in SLOW
                   or (insns[i]["target"] is not None and insns[i]["target"] <= insns[i]["addr"])
                   for i in range(lo, hi))

    hot = []
    k = first
    while k <= last:
        hot.append(k)
        ins = insns[k]
        t = ins["target"]
        if k < last and t is not None and t > ins["addr"] and t in index:
            j = index[t]
            if ins["guard"] is None or slow(k + 1, j):
                k = j
                continue
        k += 1
    cold = sorted(set(range(first, last + 1)) - set(hot))
    return hot, cold


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", type=Path, help="a saved cuobjdump -sass listing")
    ap.add_argument("--listing", type=Path, help="write each step loop's body here")
    ap.add_argument("--mhz", type=float, help="SM clock (default: clocks.max.sm)")
    ap.add_argument("--sms", type=int, default=132, help="SMs of the card (default 132)")
    args = ap.parse_args()
    if args.sass:
        sass = args.sass.read_text()
    else:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import mc_paths

        mc_paths.build()
        lib = mc_paths._LIBRARY.path()
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
    mhz, sms = args.mhz, args.sms
    if mhz is None:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        print(f"card: {out.stdout.strip()}")
        mhz = float(out.stdout.strip().split(",")[-1])
    listing = []
    for name, insns in parse(sass).items():
        if "mc_combine" in name:
            continue
        span = step_loop(insns)
        if span is None:
            print(f"{name}: no step loop found")
            continue
        hot, cold = hot_path(insns, *span)
        steps = sum(insns[i]["op"].startswith("MUFU.EX2") for i in hot)
        ops = Counter(insns[i]["op"] for i in hot)
        by_pipe = Counter()
        for op, c in ops.items():
            by_pipe[pipe_of(op)] += c
        per_step = {p: by_pipe[p] / steps for p in ("int", "fp32", "mufu", "conversion", "other")}
        cycles = issue_cycles(ops, steps)
        limit = max(cycles, key=cycles.get)
        # path-steps per second of the whole card at this clock
        rate = sms * SMSP_PER_SM * THREADS_PER_WARP * mhz * 1e6 / cycles[limit]
        print(f"{name}: step loop {insns[span[0]]['addr']:#x}..{insns[span[1]]['addr']:#x}, "
              f"{steps} steps a pass; {len(hot)} instructions run, {len(cold)} skipped "
              f"(slow paths)")
        print("  per path-step: " + ", ".join(f"{p} {v:.2f}" for p, v in per_step.items())
              + f"; total {sum(per_step.values()):.2f}")
        print("  cycles per warp-step on one sub-partition: "
              + ", ".join(f"{p} {v:.2f}" for p, v in cycles.items())
              + f" -> {limit} bound: {rate:.4e} path-steps/s on {sms} SMs at {mhz:.0f} MHz")
        print("  opcodes: " + ", ".join(f"{o} {c}" for o, c in ops.most_common()))
        listing.append(f"== {name}")
        for i in range(span[0], span[1] + 1):
            ins = insns[i]
            mark = " " if i in hot else "c"
            listing.append(f"{mark} {ins['addr']:05x} {ins['guard'] or '':6} {ins['op']} {ins['args'].strip()}")
    if args.listing:
        args.listing.write_text("\n".join(listing) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
