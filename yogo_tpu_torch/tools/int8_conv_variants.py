"""Time variants of the int8 conv kernel on one NVIDIA GPU, to see what bounds it.

    python3 -m yogo_tpu_torch.tools.int8_conv_variants [--sites block5 block6 ...] [--variants ...]

Each variant is csrc/int8_conv.cu with a few text edits (every anchor must
occur in the source exactly once, or the script stops), built with the
port's nvcc flags into yogo_tpu_torch/_build/variants/int8_conv/, all
builds at once, and launched through `ops.int8_conv.int8_conv` (its launch
plan included) with the variant's library in place of the kernel's, at the
sites of tools/int8_conv_sites.py (B=64, 772x1032, seeded codes). The
variants that still compute the conv are held bit-equal to
int8_conv_reference. Times are CUDA-event medians of 10 reps of 20
back-to-back launches; the variants take turns, two rounds. ptxas's spill
counts of each variant's build are printed beside its times. A variant
runs only at the sites whose plan it can take (`fits`).
Prints one line per timing and writes chiprun_out/int8_conv_variants.json.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

from yogo_tpu_torch.ops import int8_conv as ic
from yogo_tpu_torch.tools.int8_conv_sites import SITES, site_args
from yogo_tpu_torch.tools.timing import as_kernel, build_variants, card, cuda_ms

_LOADS = """          mbar_expect_tx(bar, pl.ring_stage_bytes);
          if (pl.route == ROUTE_IM2COL)
            tma_load_im2col(st, &tm_a, bar, cc * K_BLOCK, w0, h0, b,
                            static_cast<uint16_t>(pl.tap_dx[t]), static_cast<uint16_t>(pl.tap_dy[t]));
          else
            tma_load_2d(st, &tm_a, bar, cc * K_BLOCK, m0);
          if (!pl.resident_b) tma_load_3d(st + pl.a_stage_bytes, &tm_b, bar, cc * K_BLOCK, t, n0);"""
_MMA = "        wgmma<BN>(acc, sw128_desc(a + 32 * ks), sw128_desc(bw + 32 * ks), (kb | ks) != 0);"
_MATH = "  return activate<ACT>(__fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias));"
_REQUANT = ("  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(div_by_scale(h, s, inv), -127.f), "
            "127.f)));")
_DIV = "  return fabsf(q0) < 4194304.f ? q2 : q0;"
_STORE = "        tma_store_2d(&tm_out, buf, n0 + sn * SUB_COLS, m0);"

_PRODUCER = """    int stage = 0;
    uint32_t phase = 0;
    for (int mt = m_first; mt < pl.m_tiles; mt += m_step) {
      const int m0 = mt * BM;
      // im2col: the top-left input pixel of the window of output pixel m0
      const int b = m0 / hw, r = m0 - b * hw, oy = r / p.Wo, ox = r - oy * p.Wo;
      const int w0 = ox * pl.traversal_stride + pl.box_lower;
      const int h0 = oy * pl.traversal_stride + pl.box_lower;
      for (int t = 0; t < pl.taps; ++t) {
        for (int cc = 0; cc < pl.chunks; ++cc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t st = base + pl.ring_offset + stage * pl.ring_stage_bytes;
          const uint32_t bar = full0 + 8 * stage;
""" + _LOADS + """
          if (++stage == pl.stages) stage = 0, phase ^= 1;
        }
      }
    }
    return;"""
# each consumer its own ring of stages / consumers slots, which the producer
# fills for whichever consumer has room: no consumer waits for another's
# mainloop, so up to `consumers` mainloops run at once
_PRIVATE_PRODUCER = """    const int sc = pl.stages / NC;  // consumer c's ring: slots c * sc .. c * sc + sc - 1
    const int my_tiles = m_first < pl.m_tiles ? (pl.m_tiles - 1 - m_first) / m_step + 1 : 0;
    int next[NC];  // consumer c's next k-block over its tiles j = c, c + NC, ...
#pragma unroll
    for (int c = 0; c < NC; ++c) next[c] = 0;
    for (bool more = true; more;) {
      more = false;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int total = my_tiles > c ? ((my_tiles - 1 - c) / NC + 1) * pl.k_blocks : 0;
        if (next[c] >= total) continue;
        more = true;
        const int slot = c * sc + next[c] % sc;
        if (!mbar_test_wait(empty0 + 8 * slot, ((next[c] / sc) & 1) ^ 1)) continue;
        const int j = c + NC * (next[c] / pl.k_blocks), kb = next[c] % pl.k_blocks;
        const int t = kb / pl.chunks, cc = kb - t * pl.chunks;
        const int m0 = (m_first + j * m_step) * BM;
        const int b = m0 / hw, r = m0 - b * hw, oy = r / p.Wo, ox = r - oy * p.Wo;
        const int w0 = ox * pl.traversal_stride + pl.box_lower;
        const int h0 = oy * pl.traversal_stride + pl.box_lower;
        const uint32_t st = base + pl.ring_offset + slot * pl.ring_stage_bytes;
        const uint32_t bar = full0 + 8 * slot;
""" + _LOADS + """
        ++next[c];
      }
    }
    return;"""
_TEST_WAIT = """__device__ __forceinline__ bool mbar_test_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\\n.reg .pred p;\\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
      "selp.u32 %0, 1, 0, p;\\n}\\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

"""
_WAIT_DOC = "// until the phase of parity `parity` has completed\n"
_DONE_WAIT = "    if (j > 0) mbar_wait(done0 + 8 * ((j - 1) % NC), ((j - 1) / NC) & 1);\n"
_RING_POS = """    const int it = j * pl.k_blocks;
    int stage = it % pl.stages;
    uint32_t phase = (it / pl.stages) & 1;
    // the ring slot of the k-block `back` k-blocks before the current one
    const auto slot_back = [&](int back) { return stage >= back ? stage - back : stage - back + pl.stages; };
"""
_FULL = """      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = base + pl.ring_offset + stage * pl.ring_stage_bytes;
"""
_NEXT_STAGE = """      if (++stage == pl.stages) stage = 0, phase ^= 1;
    }
    if (lane == 0) mbar_arrive(done0 + 8 * c);  // the next consumer may start its mainloop
"""
PRIVATE_RINGS = [
    (_WAIT_DOC, _TEST_WAIT + _WAIT_DOC),
    (_PRODUCER, _PRIVATE_PRODUCER),
    (_DONE_WAIT, ""),
    (_RING_POS, """    const int sc = pl.stages / NC, it = (j / NC) * pl.k_blocks;
    int stage = it % sc;
    uint32_t phase = (it / sc) & 1;
    const auto slot_back = [&](int back) { return c * sc + (stage >= back ? stage - back : stage - back + sc); };
"""),
    (_FULL, """      mbar_wait(full0 + 8 * (c * sc + stage), phase);
      const uint32_t a = base + pl.ring_offset + (c * sc + stage) * pl.ring_stage_bytes;
"""),
    (_NEXT_STAGE, """      if (++stage == sc) stage = 0, phase ^= 1;
    }
"""),
]
# variant -> the launch-plan constants it changes, both in ops/int8_conv.py
# (for the duration of its launches) and in csrc/int8_conv.cu (a text edit),
# so the C entry still takes the plan
PLAN_CONSTANTS = {"weights_streamed": {"MIN_RESIDENT_STAGES": 1000}, "ring_3": {"MAX_STAGES": 3}}


def _constant_edits(name: str) -> list:
    return [(f"constexpr int {k} = {getattr(ic, k)};", f"constexpr int {k} = {v};")
            for k, v in PLAN_CONSTANTS[name].items()]


_NO_LOADS = [(_LOADS, "          mbar_arrive(bar);")]
_NO_EPILOGUE_MATH = [(_MATH, "  return __int_as_float(acc);"),
                     (_REQUANT, "  return static_cast<int8_t>(__float_as_int(h));")]
_NO_STORES = [(_STORE, "")]

# name -> (edits, whether the output is still the conv's, what it shows)
VARIANTS = {
    "kernel": ([], True, "csrc/int8_conv.cu as it is"),
    "fdiv_rn": ([(_DIV, "  return __fdiv_rn(h, s);")], True,
                "the requant divides with __fdiv_rn (a branch to its slow path an element)"),
    "two_kblocks_in_flight": ([("constexpr int IN_FLIGHT = 1;", "constexpr int IN_FLIGHT = 2;")], True,
                              "a consumer leaves two k-blocks of products running, not one"),
    "no_epilogue_math": (_NO_EPILOGUE_MATH, False,
                         "the epilogue stores the accumulators' bits: no dequant, activation or requant"),
    "no_stores": (_NO_STORES, False, "everything but the TMA stores of the output"),
    "no_mma": ([(_MMA, "        (void)bw;")], False,
               "the loads and the epilogue without a product: the pipeline and the stores alone"),
    "no_loads": (_NO_LOADS, False,
                 "the products and the epilogue on whatever the ring holds: no A (or streamed W) traffic"),
    "products_only": (_NO_LOADS + _NO_EPILOGUE_MATH + _NO_STORES, False,
                      "the consumers' mainloops, taking turns, and the epilogue's staging alone: "
                      "no loads, no epilogue arithmetic, no stores"),
    "private_rings": (PRIVATE_RINGS, True,
                      "each consumer its own ring (stages / consumers deep): the consumers' mainloops "
                      "run at once instead of taking turns"),
    "weights_streamed": (_constant_edits("weights_streamed"), True,
                         "the weights through the ring with the codes, never resident"),
    "ring_3": (_constant_edits("ring_3"), True, "a ring of 3 stages, not as deep as shared memory allows"),
}
# variant -> whether it can take a plan (a private ring needs a slot in use
# and a slot loading: two)
FITS = {"private_rings": lambda plan: plan.stages // plan.consumers >= 2}


def _spills(log: str) -> dict:
    """Max spill stores / loads (bytes) over the instantiations of a build."""
    st = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    ld = [int(x) for x in re.findall(r"(\d+) bytes spill loads", log)]
    return {"spill_stores": max(st, default=0), "spill_loads": max(ld, default=0)}


@contextmanager
def _as_kernel(name: str, lib):
    """Inside the block, ops.int8_conv launches variant `name`'s `lib`
    (kernels.load returns it) with its plan constants."""
    saved = {k: getattr(ic, k) for k in PLAN_CONSTANTS.get(name, {})}
    for k, v in PLAN_CONSTANTS.get(name, {}).items():
        setattr(ic, k, v)
    try:
        with as_kernel("int8_conv", lib):
            yield
    finally:
        for k, v in saved.items():
            setattr(ic, k, v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sites", nargs="*", default=list(SITES))
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_conv_variants: CUDA is not available", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    libs = build_variants("int8_conv", {name: VARIANTS[name][0] for name in a.variants})
    report = {"device": smi, "variants": {}, "sites": {}}
    for name, (_, log) in libs.items():
        report["variants"][name] = {"what": VARIANTS[name][2], **_spills(log)}
        print(f"variant {name}: {json.dumps(report['variants'][name])}", flush=True)
    for site in a.sites:
        args, kw = site_args(site, 64)
        q, w8 = args[:2]
        plan = ic.launch_plan(*q.shape, *w8.shape[:2], kw["stride"], kw["padding"],
                              out_s8=kw["out_scale"] is not None, act=kw["act"], num_sms=ic._sm_count(q.device))
        want = ic.int8_conv_reference(*args, **kw)
        launch = {name: lib for name, (lib, _) in libs.items() if FITS.get(name, lambda _: True)(plan)}
        for name, lib in launch.items():
            with _as_kernel(name, lib):
                got = ic.int8_conv(*args, **kw)
            torch.cuda.synchronize()
            if VARIANTS[name][1] and not torch.equal(got, want):
                raise AssertionError(f"variant {name} at {site}: differs from the plain version")
        del want, got
        rec = report["sites"][site] = {name: [] for name in launch}
        for _ in range(2):
            for name, lib in launch.items():
                with _as_kernel(name, lib):
                    rec[name].append(cuda_ms(lambda: ic.int8_conv(*args, **kw)))
        print(f"{site}: " + json.dumps(rec), flush=True)
        del args
        torch.cuda.empty_cache()
    out_dir = Path.cwd() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "int8_conv_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
