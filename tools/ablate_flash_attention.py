#!/usr/bin/env python3
"""Where the flash-attention kernel K7's time goes: variants of it, each
with one part of its work cut out or done another way, timed at
tinyllama-1.1b's prefill and decode.

    python3 tools/ablate_flash_attention.py [--out FILE]

Each variant is a copy of ``src/repro_torch/kernels/csrc/
flash_attention.cu`` with one text edit (``VARIANTS``; the tool fails if
the source no longer has the text it edits), built with the port's nvcc
flags, all at once, into ``build/ablate_flash_attention/``, and timed with
CUDA events (``chip_smoke.event_ms``) through its C launcher: the
tensor-core kernel at (B, H, Hkv, L, D) = (4, 32, 4, 1024, 64), causal
(``K7_PREFILL``), at qwen3-moe's (D = 128) and recurrentgemma-2b's (D =
256, window 2048) prefills, and the split kernel at the decode
(``K7_DECODE``, Lq = 1, Lk = 1024) with the planned runs; a variant that
does not fit a head width's tiles is reported as refused there.  A
variant that cuts work gives wrong outputs by design: only its time
means something, and its difference to the full kernel is what the cut
part costs while the rest runs (the parts overlap, so the differences do
not add up).  Each variant runs twice, in
turns.  Prints the card's name and power limit, each variant's times and
max |Δ| against the plain version, the prefill kernel's registers and
spill bytes, and a JSON summary last.  Needs a CUDA device.

    python3 tools/ablate_flash_attention.py --backward [--out FILE]

does the same for K7's backward (``BWD_VARIANTS``, built into
``build/ablate_flash_attention_bwd/``): each variant's whole backward
(``flash_attention_bwd_launch``, given the forward's lse and output) at
tinyllama-1.1b's and qwen3-moe's causal prefill (``K7_BWD_TIMED``) and
at recurrentgemma-2b's (``K7_RG_PREFILL``: D = 256, window 2048), the
unchanged kernel also with the dk/dv pass's rows cut into runs of
``BWD_RUN_ROWS`` (D ≤ 128), and the registers and spill bytes of the
dk/dv and dq kernels at D = 64 and 128 and of the D = 256 passes.

    python3 tools/ablate_flash_attention.py --backward --bf16 [--baseline
        OLD.cu] [--out FILE]

does it for the bf16 backward (``BWD_BF16_VARIANTS``: P and dS in two
bf16 pieces or one, twice the rows a dk/dv tile, registers bounded for
more blocks an SM, P by exp2f; built into
``build/ablate_flash_attention_bwd_bf16/``) on bf16 operands at
``K7_BWD_TIMED``, with each gradient's mean signed error against the
plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "flash_attention.cu")
OUT_DIR = os.path.join(ROOT, "build", "ablate_flash_attention")

_QK = ("        if (kLoQ) mma_tf32(s[n], al, kf.x, kf.y);\n"
       "        if (lo_kv) mma_tf32(s[n], ah, kf.z, kf.w);\n"
       "        mma_tf32(s[n], ah, kf.x, kf.y);\n")
_PV = ("          if (j == 0)\n"
       "            mma_tf32_z(c[n], pl, b0.x, b1.x);\n"
       "          else\n"
       "            mma_tf32(c[n], pl, b0.x, b1.x);\n"
       "          if (lo_kv) mma_tf32(c[n], ph, b0.y, b1.y);\n"
       "          mma_tf32(c[n], ph, b0.x, b1.x);\n")
_PV_RUN = ("          mma_tf32(acc[n0 + n], pl, b0.x, b1.x);\n"
           "          if (lo_kv) mma_tf32(acc[n0 + n], ph, b0.y, b1.y);\n"
           "          mma_tf32(acc[n0 + n], ph, b0.x, b1.x);\n")
_PADD = ("#pragma unroll\n"
         "      for (int n = 0; n < NC; ++n)\n"
         "#pragma unroll\n"
         "        for (int e = 0; e < 4; ++e)\n"
         "          acc[n0 + n][e] = fmaf(acc[n0 + n][e], corr[e >> 1], "
         "c[n][e]);\n")
#: where the rescale acc *= corr stood before the P V products
_RESCALE_AT = "      l[i] = l[i] * corr[i] + sum[i];\n    }\n"
_RESCALE = ("#pragma unroll\n"
            "    for (int n = 0; n < NN; ++n)\n"
            "#pragma unroll\n"
            "      for (int c = 0; c < 4; ++c) acc[n][c] *= corr[c >> 1];\n")
_NC = "  constexpr int NC = D > 128 ? 16 : 4;"
_SPLIT_LOOP = ("  for (int idx = threadIdx.x; idx < bka<D>() * D / 4; "
               "idx += kThreadsA) {")
_SPLIT_UNROLLED = ("#pragma unroll\n"
                   "  for (int i = 0; i < bka<D>() * D / 4 / kThreadsA; ++i)"
                   " {\n"
                   "    const int idx = threadIdx.x + i * kThreadsA;")
_EX2 = "s[n][c] = ok ? ex2(s[n][c] - m[c >> 1]) : 0.0f;"
_EXP2F = "s[n][c] = ok ? exp2f(s[n][c] - m[c >> 1]) : 0.0f;"
#: name: ((text of the kernel, replacement), ...).
VARIANTS = {
    "full": (),
    # TF32 rounding by the PTX conversion instead of the integer form
    "cvt": (("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             "  uint32_t r;\n"
             "  asm volatile(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : "
             "\"f\"(x));\n  return r & 0xffffe000u;"),),
    # one TF32 product (hi·hi) instead of three
    "one_product": ((_QK, "        mma_tf32(s[n], ah, kf.x, kf.y);\n"),
                    (_PV, "          if (j == 0)\n"
                          "            mma_tf32_z(c[n], ph, b0.x, b1.x);\n"
                          "          else\n"
                          "            mma_tf32(c[n], ph, b0.x, b1.x);\n")),
    # P V chained into the running accumulator across key tiles (the
    # biased order before the partials; F7)
    "running": ((_PV, _PV_RUN), (_PADD, ""),
                (_RESCALE_AT, _RESCALE_AT + _RESCALE)),
    # the partials zeroed in registers before their first product
    "zeroed": ((_PV, _PV.replace("mma_tf32_z(", "mma_tf32(")),
               ("      float c[NC][4];\n",
                "      float c[NC][4] = {};\n")),
    # partials for 8 of o's 8-column tiles at a time, at every head width
    "chunk8": ((_NC, "  constexpr int NC = D / 8 < 8 ? D / 8 : 8;"),),
    "no_qk": ((_QK, ""),),
    "no_pv": ((_PV, ""),),
    # p = 2^x replaced by x
    "no_exp": ((_EX2, "s[n][c] = ok ? (s[n][c] - m[c >> 1]) : 0.0f;"),),
    "no_split_pass": (("    split_tile<TQ, TKV, D>(Ksp, Vsp, Kr, Vr, kl, vl, "
                       "a, kt, kr.hi);\n", ""),),
    # two blocks an SM (no register bound), and 64-key tiles with them
    "two_blocks": (("__launch_bounds__(kThreadsA, D <= 64 ? 3 : 1)",
                    "__launch_bounds__(kThreadsA)"),),
    "tile64_two_blocks": (
        ("constexpr int kBKA = 32;", "constexpr int kBKA = 64;"),
        ("__launch_bounds__(kThreadsA, D <= 64 ? 3 : 1)",
         "__launch_bounds__(kThreadsA)")),
    # tried, and slower: the split pass's loop unrolled, four blocks an SM
    # (at most 128 registers a thread)
    "split_unroll": ((_SPLIT_LOOP, _SPLIT_UNROLLED),),
    "four_blocks": (("__launch_bounds__(kThreadsA, D <= 64 ? 3 : 1)",
                     "__launch_bounds__(kThreadsA, D <= 64 ? 4 : 1)"),),
    # p = 2^x by exp2f instead of ex2.approx (2-4 % slower at D = 64 / 128)
    "exp2f": ((_EX2, _EXP2F),),
    # the split kernel without the combine launch
    "no_combine": (("  comb<<<cgrid, D, csmem, stream>>>(a);\n", ""),),
}


_MMA3_ADD = ("  float p[4];\n"
             "  mma_tf32_z(p, al, b0h, b1h);\n"
             "  mma_tf32(p, ah, b0l, b1l);\n"
             "  mma_tf32(p, ah, b0h, b1h);\n"
             "#pragma unroll\n"
             "  for (int e = 0; e < 4; ++e) c[e] += p[e];\n")
_DQ_ADD = "        mma3_add(acc[m], dh, dl, k0.x, k1.x, k0.y, k1.y);\n"
#: The dk/dv pass's products (D <= 128): a partial a row tile, the
#: 8-column tiles m of dK, dV outer and the tile's row fragments inner.
_DKDV_TILE = """    uint32_t ph[NTW][4], pl[NTW][4], sh[NTW][4], sl[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      c_to_a(st[n], ph[n], pl[n]);
      c_to_a(dp[n], sh[n], sl[n]);
    }
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      float pv[4], pk[4];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int r0 = 8 * (half * NTW + n);
        const uint2 o0 = L.one(Os, r0, 0, m);
        const uint2 o1 = L.one(Os, r0, 1, m);
        const uint2 q0 = L.one(Qs, r0, 0, m);
        const uint2 q1 = L.one(Qs, r0, 1, m);
        if (n == 0) {
          mma_tf32_z(pv, pl[n], o0.x, o1.x);
          mma_tf32_z(pk, sl[n], q0.x, q1.x);
        } else {
          mma_tf32(pv, pl[n], o0.x, o1.x);
          mma_tf32(pk, sl[n], q0.x, q1.x);
        }
        mma_tf32(pv, ph[n], o0.y, o1.y);
        mma_tf32(pv, ph[n], o0.x, o1.x);
        mma_tf32(pk, sh[n], q0.y, q1.y);
        mma_tf32(pk, sh[n], q0.x, q1.x);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[m][e] += pv[e];
        dk[m][e] += pk[e];
      }
    }
"""


def _dkdv_loop(mma):
    """The dk/dv pass's products with the fragments outer, each through
    ``mma`` ("mma3": chained into dK, dV; "mma3_add": a partial a
    fragment)."""
    return f"""#pragma unroll
    for (int n = 0; n < NTW; ++n) {{
      uint32_t ph[4], pl[4], sh[4], sl[4];
      c_to_a(st[n], ph, pl);
      c_to_a(dp[n], sh, sl);
      const int r0 = 8 * (half * NTW + n);
#pragma unroll
      for (int m = 0; m < NS; ++m) {{
        const uint2 o0 = L.one(Os, r0, 0, m);
        const uint2 o1 = L.one(Os, r0, 1, m);
        const uint2 q0 = L.one(Qs, r0, 0, m);
        const uint2 q1 = L.one(Qs, r0, 1, m);
        {mma}(dv[m], ph, pl, o0.x, o1.x, o0.y, o1.y);
        {mma}(dk[m], sh, sl, q0.x, q1.x, q0.y, q1.y);
      }}
    }}
"""


#: The backward's variants: name: ((text, replacement), ...).
BWD_VARIANTS = {
    "full": (),
    # tiles of 64 rows at D = 64 in the dk/dv pass (one block an SM)
    "br64": (("constexpr int bwd_br() { return D > 32 ? 32 : 64; }",
              "constexpr int bwd_br() { return D > 64 ? 32 : 64; }"),),
    # dK and dV (D <= 128) chained into their accumulators, or given a
    # partial a fragment; dQ (and the D = 256 passes) chained
    "running_dkdv": ((_DKDV_TILE, _dkdv_loop("mma3")),),
    "dkdv_fragment_partial": ((_DKDV_TILE, _dkdv_loop("mma3_add")),),
    "running_dq": ((_DQ_ADD, _DQ_ADD.replace("mma3_add(", "mma3(")),),
    # the D = 256 passes (D split over the warps) at D = 128 (tried, and
    # slower: 10.5 against 8.3 ms at qwen3-moe's prefill)
    "wide128": (("  constexpr bool kBf = sizeof(TO) == 2, kWide = D > 128;",
                 "  constexpr bool kBf = sizeof(TO) == 2, "
                 "kWide = D > 64 && !kBf;"),),
    # every accumulator chained (the biased order before the partials)
    "running": ((_DKDV_TILE, _dkdv_loop("mma3")),
                (_MMA3_ADD, "  mma3(c, ah, al, b0h, b1h, b0l, b1l);\n")),
}
_BF_LO = """    mma_bf16_z(p0, l[0], bt[0][0], bt[0][1]);
    mma_bf16_z(p1, l[0], bt[0][2], bt[0][3]);
#pragma unroll
    for (int s = 1; s < NR; ++s) {
      mma_bf16(p0, l[s], bt[s][0], bt[s][1]);
      mma_bf16(p1, l[s], bt[s][2], bt[s][3]);
    }
"""
_BF_MID = """#pragma unroll
    for (int s = 0; s < NR; ++s) {
      mma_bf16(p0, mid[s], bt[s][0], bt[s][1]);
      mma_bf16(p1, mid[s], bt[s][2], bt[s][3]);
    }
"""
_BF_ZERO = """#pragma unroll
    for (int e = 0; e < 4; ++e) p0[e] = p1[e] = 0.0f;
"""
#: The bf16 backward's variants (``--backward --bf16``): name: ((text,
#: replacement), ...).
BWD_BF16_VARIANTS = {
    "full": (),
    # P and dS as two bf16 pieces (hi, mid: 16 bits), or one (hi)
    "two_piece": ((_BF_LO, _BF_ZERO),),
    "one_piece": ((_BF_LO, _BF_ZERO), (_BF_MID, "")),
    # twice the rows a dk/dv tile
    "br_x2": (("constexpr int bf_br() { return D > 64 ? 16 : 32; }",
               "constexpr int bf_br() { return D > 64 ? 32 : 64; }"),),
    # P = 2^x by exp2f instead of ex2.approx.ftz
    "exp2f": (("      float p = ex2(st[j][e] * c - lse);",
               "      float p = exp2f(st[j][e] * c - lse);"),
              ("      float p = ex2(s[j][e] * c - w.x);",
               "      float p = exp2f(s[j][e] * c - w.x);")),
    # registers bounded for three blocks an SM at D <= 64, in each pass
    "blocks3": (
        ("__launch_bounds__(kBfThreads, 2)\n    attn_bwd_dkdv_bf16_kernel",
         "__launch_bounds__(kBfThreads, D > 64 ? 2 : 3)\n"
         "    attn_bwd_dkdv_bf16_kernel"),
        ("__launch_bounds__(kBfThreads, 2)\n    attn_bwd_dq_bf16_kernel",
         "__launch_bounds__(kBfThreads, D > 64 ? 2 : 3)\n"
         "    attn_bwd_dq_bf16_kernel")),
}

#: Rows a run of the dk/dv pass the unchanged backward is also timed at.
BWD_RUN_ROWS = (512, 2048, 4096)


def build_variants(variants=None, out_dir=OUT_DIR, kernels=(
        "attn_tc_kernelIffLi64ELb0EEvNS_4ArgsE",), baseline=None) -> dict:
    """Write and compile every variant (one nvcc each, all at once), and
    the source at ``baseline`` unedited as variant "baseline" if given;
    return {name: (ctypes handle, {kernel: (registers, bytes of spill
    stores)})} for the mangled-name tails ``kernels`` (by default the
    float32 D = 64 prefill kernel)."""
    from repro_torch.kernels import _build

    variants = dict(VARIANTS if variants is None else variants)
    src = open(SOURCE).read()
    if baseline:
        variants["baseline"] = ()
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name, edits in variants.items():     # every edit checked first
        text = open(baseline).read() if name == "baseline" else src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ablate_flash_attention: variant {name} "
                                   f"does not find {old!r} once")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_flash_attention: {name} failed to "
                               f"build:\n{log[-4000:]}")
        found = {}
        for kern in kernels:
            regs = re.search(re.escape(kern) + r"\n.*?Used (\d+) registers",
                             log, re.S)
            spill = re.search(re.escape(kern) + r"\n\s*\d+ bytes stack "
                              r"frame, (\d+) bytes spill stores", log)
            found[kern] = (int(regs.group(1)) if regs else None,
                           int(spill.group(1)) if spill else None)
        libs[name] = (ctypes.CDLL(os.path.join(out_dir, f"{name}.so")),
                      found)
    return libs


def backward(cs, torch, out, baseline=None, bf16=False) -> int:
    """The ``--backward`` mode, with ``bf16`` its bf16 form (see the
    module's docstring)."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_lse)
    from repro_torch.kernels.flash_attention.kernel import _BWD_ARGTYPES
    from repro_torch.kernels.flash_attention.ops import (K7_BWD_ROWS,
                                                         plan_k7_bwd)

    card = cs.card_line()
    print(card, flush=True)
    cs.no_tf32(torch)
    if bf16:
        kernels = [f"attn_bwd_{k}_bf16_kernelILi{D}EEEvNS_7BwdArgsE"
                   for k in ("dkdv", "dq") for D in (64, 128)]
        libs = build_variants(BWD_BF16_VARIANTS, OUT_DIR + "_bwd_bf16",
                              kernels, baseline)
    else:
        kernels = [f"attn_bwd_{k}_kernelILi{D}EEEvNS_7BwdArgsE"
                   for k in ("dkdv", "dq") for D in (64, 128)] + [
            f"attn_bwd_{k}_wide_kernelILi256EEEvNS_7BwdArgsE"
            for k in ("dkdv", "dq")]
        libs = build_variants(BWD_VARIANTS, OUT_DIR + "_bwd", kernels,
                              baseline)
    stream = torch.cuda.current_stream().cuda_stream
    us, err = {}, {}
    shapes = list(cs.K7_BWD_TIMED) + ([] if bf16 else [cs.K7_RG_PREFILL])
    for shape in shapes:
        B, H, Hkv, Lq, Lk, D, causal, window = shape
        q, k, v, do = cs.k7_bwd_inputs(torch, B, H, Hkv, Lq, Lk, D)
        if bf16:
            q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
        rows = H // Hkv * Lq
        rows_pad = -(-rows // K7_BWD_ROWS) * K7_BWD_ROWS
        stats = torch.empty(2 * B * Hkv * rows_pad, device="cuda")
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(k))
        strides = [x for t in (q, k, v, o, do) for x in t.stride()[:3]]
        runs_of = {None: plan_k7_bwd(H, Hkv, Lq, D, bf16=bf16)}
        if D <= 128:
            runs_of.update({r: -(-rows // r) for r in BWD_RUN_ROWS})
        # the backward's error against the plain version, and with bf16
        # each gradient's bias against it (the mean signed error along
        # the plain value's sign over its mean magnitude)
        bias = {}
        for name, (lib, _) in libs.items():
            fn = lib.flash_attention_bwd_launch
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
            for rr, runs in runs_of.items():
                if rr is not None and name != "full":
                    continue
                part = torch.empty(2 * runs * k.numel(), device="cuda")

                def go(fn=fn, runs=runs, part=part):
                    e = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse)
                             + outs), stats.data_ptr(), part.data_ptr(),
                           runs, B, H, Hkv, Lq, Lk, D, *strides, int(causal),
                           window or 0, float(D ** -0.5), int(bf16), stream)
                    if e:
                        raise RuntimeError(f"ablate_flash_attention: CUDA "
                                           f"error {e}")
                key = f"D={D} {name}" + ("" if rr is None else
                                         f" runs of {rr} rows")
                go()
                torch.cuda.synchronize()
                err[key] = max(float((a.float() - b).abs().max())
                               for a, b in zip(outs, want))
                if bf16:
                    bias[key] = [cs.signed_error(a, b)[1]
                                 for a, b in zip(outs, want)]
                us[key] = [1e3 * cs.event_ms(torch, go, reps=20)
                           for _ in range(2)]
                print(f"{key}: {', '.join(f'{t:.3f}' for t in us[key])} us, "
                      f"max |Δ| {err[key]:.3g}"
                      + (f", bias dq dk dv {bias[key]}" if bf16 else ""),
                      flush=True)
    summary = {"card": card, "us": us, "max_abs_err": err,
               "registers": {n: r for n, (_, r) in libs.items()}}
    if bf16:
        summary["bias"] = bias
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON to this file")
    ap.add_argument("--backward", action="store_true",
                    help="ablate K7's backward instead of its forward")
    ap.add_argument("--baseline", default=None,
                    help="with --backward: also time this copy of "
                         "flash_attention.cu (say, the parent commit's; its "
                         "flash_attention_bwd_launch must take the same "
                         "arguments) unedited, in turns with the variants")
    ap.add_argument("--bf16", action="store_true",
                    help="with --backward: the bf16 backward's variants "
                         "(BWD_BF16_VARIANTS) on bf16 operands at "
                         "K7_BWD_TIMED")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs          # puts ROOT/src first on sys.path
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_attention: no CUDA device", file=sys.stderr)
        return 2
    if a.backward:
        return backward(cs, torch, a.out, a.baseline, a.bf16)
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.flash_attention.kernel import _ARGTYPES
    from repro_torch.kernels.flash_attention.ops import plan_k7

    card = cs.card_line()
    print(card, flush=True)
    cs.no_tf32(torch)
    libs = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for label, shape in (("prefill", cs.K7_PREFILL),
                         ("decode", cs.K7_DECODE),
                         ("prefill D=128", cs.K7_MOE["qwen3-moe-235b-a22b"]),
                         ("prefill D=256", cs.K7_RG_PREFILL)):
        B, H, Hkv, Lq, Lk, D, causal, window = shape
        rng = np.random.RandomState(Lq + Lk)
        q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
                   for s in ((B, H, Lq, D), (B, Hkv, Lk, D),
                             (B, Hkv, Lk, D)))
        splits = plan_k7(B, H, Hkv, Lq, Lk, window,
                         sm_count(torch.device("cuda"))).splits
        part = torch.empty(B * H * Lq * splits * (D + 2), device="cuda")
        want = cs.k7_want(torch, q, k, v, None, causal, window)
        cases[label] = (shape, q, k, v, torch.empty_like(q), part, splits,
                        want)

    def launcher(lib, label):
        (B, H, Hkv, Lq, Lk, D, causal, window), q, k, v, out, part, \
            splits, _ = cases[label]
        fn = lib.flash_attention_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None, None, B, H, Hkv, Lq, Lk, D, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], 0, 0, 0, 0, int(causal),
                0 if window is None else window, float(D ** -0.5), 0, 0,
                part.data_ptr(), splits, None, None, stream)

        def go():
            err = fn(*args)
            if err:
                raise RuntimeError(f"ablate_flash_attention: CUDA error "
                                   f"{err}")
        return go

    us, err = {}, {}
    for _ in range(2):
        for name, (lib, _) in libs.items():
            for label in cases:
                key = f"{label} {name}"
                go = launcher(lib, label)
                try:       # a variant may not fit a head width (its tiles)
                    go()
                except RuntimeError as e:
                    err[key] = str(e)
                    continue
                torch.cuda.synchronize()
                err[key] = float((cases[label][4] - cases[label][7]).abs()
                                 .max())
                us.setdefault(key, []).append(1e3 * cs.event_ms(torch, go))
    for key, times in us.items():
        print(f"{key}: {', '.join(f'{t:.3f}' for t in times)} us, max |Δ| "
              f"{err[key]:.3g}", flush=True)
    for key in sorted(set(err) - set(us)):
        print(f"{key}: refused ({err[key]})", flush=True)
    summary = {"card": card,
               "registers": {n: list(r.values())[0]
                             for n, (_, r) in libs.items()},
               "splits": cases["decode"][6], "us": us, "max_abs_err": err}
    print("registers, spill bytes (float32 D = 64 prefill kernel): "
          + ", ".join(f"{n} {r[0]}, {r[1]}"
                      for n, r in summary["registers"].items()), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
