#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.  It
imports only ``repro_torch`` (from ``src/`` beside this file) and:

1. prints the card (``nvidia-smi --query-gpu=name,power.limit``);
2. builds the CUDA exchange kernels from ``src/repro_torch/csrc``, prints
   the registers, shared memory and spills of kernels 1, 2 and 5 from the
   ``-Xptxas=-v`` report with the occupancy they imply (kernel 5's at
   T = 2 and at T = 32 tables), and counts the
   integer instructions of the device PRNG (Philox4x32-10) in the SASS
   of its test entry (``cuobjdump -sass``): the integer term of the
   device-PRNG variants' bound;
3. holds every kernel against its plain PyTorch version on the card over
   bits {4, 8} x q_norm {inf, 2} x K {1, 2, 8} x bucket {512, 130, 2,
   1024, 4096, 256 (the KV-cache's), and 1023 for int8}, with 37 rows (not a multiple of any
   tile) and with more rows than the card holds warps (kernels 1 and 2's
   grid-stride loop wraps), all-zero rows and a NaN row (a NaN
   coordinate for kernel 1, a NaN worker norm for kernels 2 and 4), and
   kernels 1 and 2 with exponential level tables (both bracket searches):
   payload indices and packed bytes exactly equal for q = inf (for q = 2,
   exactly equal in every row whose norm is bit-identical, else at most
   one level apart), f32 outputs and norms within rtol 1e-6 with NaN in
   the same places.  Kernel 5 (segment-fused
   quantize∘dequantize) over T {1, 2, 3} stacked tables with mixed symbol
   counts at buckets {512, 130, 37}, T = 32 tables of 2-128 symbols, two
   128-symbol tables (exponential: the binary search), buckets 1024 and
   1023, more rows than the card holds warps and rows whose table id lies
   outside [0, T) (NaN rows), x q_norm {inf, 2} x stochastic / nearest
   rounding, with zero rows and a NaN row: bit-equal for q = inf, rtol
   1e-6 for q = 2 (over the 4 M coordinates of the many-row case a q = 2
   coordinate may differ only as a rounding tie that the L2 norm's last
   bit decides: ``_segment_ties``).  The device PRNG (TPU kernel B5):
   Philox's known-answer vectors through its test entry, then kernels 1
   (int8, int4), 2 and 5 (kernel 5 over the same cases) drawing their own
   noise (kernels 1 and 2 at the same buckets, rows and NaN rows),
   bit-equal to the same kernels fed ``philox_uniform``'s draw of the seed
   on the card, and held to the plain versions;
4. drives the paths, each run with the launch counts reset just before
   it and read just after:
   a. the LM train step through the training entry point
      (``repro_torch.launch.train.run``) at the full width of
      tinyllama-1.1b (22 layers, d_model 2048, 32 heads / 4 kv heads,
      d_ff 5632, vocab 32000, bf16 layer weights, random from a seed):
      3 qgenx ``de`` steps with the int8 two_phase exchange, the same 3
      with ``ExchangeConfig(use_device_prng=True)`` (only the device-PRNG
      kernels 1 and 2 may launch; step times and peak memory printed
      beside the host-noise run's), 2 ``optda`` steps with the int4
      gather exchange, then 2 ``extra_adam`` steps with the layerwise
      int4 / int8 two_phase exchange, batch 4 x seq 512 on the one card
      (K = 1).  Every kernel of the path must have launched, every loss
      be finite, ``wire_bytes`` equal the analytic buffer sizes and the
      qgenx runs' ``coded_bits_est`` lie in (0, 8 x the payload bytes]
      a gradient exchange; peaks are printed beside those of commit
      5a288aa, before the step computed ``coded_bits_est``.  A
      reduced-size run on the card is then held against the same run on
      the CPU (same weights, exact exchange; int8 with host noise and
      with the device PRNG from the same seeds);
   c. the local-update regime at the same width but 6 of the 22 layers
      (the depth cut keeps the script's time, a ``reduced:`` line; the
      phase is checkpoint I/O): 4 qgenx ``de`` int8
      two_phase steps with ``sync_every=2``, ``recenter_every=4`` and a
      checkpoint every 2 steps, the wire recorder on: ``wire_bytes`` 0
      on local steps and the analytic bytes plus the 16,384 probe bytes
      on sync steps (and the recorder's total), ``param_drift`` 0,
      ``coded_bits_est`` within its bound, kernels 1-3 once per
      exchange; then the step-2 checkpoint restored on the card (every
      leaf crc-equal) and a second run resumed from it (its losses held
      to the first run's), with each save's and restore's bytes and
      seconds, the cost of ``coded_bits_tree``, step times and peak
      memory printed (``local_update_path``);
   d. QAda adaptive levels at the same width: 4 qgenx ``de`` int8
      two_phase steps with ``--level-schedule qada --level-update-every
      2`` (8 exchange calls, 4 refreshes), the wire recorder on: the call
      count, a final table moved from uniform and valid, ``wire_bytes``
      each step 2 x (the analytic bytes + the histogram's 2048), the
      recorder's ``qada_hist`` once a call, kernels 1-3 once a call, and
      kernels 1 and 2 on the run's table bit-equal to their plain versions
      (the bracket branch it takes is printed); the histogram pass's and
      each refresh's ms, step times beside phase 4a's fixed-schedule run
      and the peak are printed (``qada_path``);
   f. the sparse compressors at the same width: 3 qgenx ``de`` steps
      under ``--compressor ef21-topk --ef-topk-frac 0.25`` and 3 under
      ``--compressor randk --rand-frac 0.25``: ``wire_bytes`` 2 x 8k a
      step, the recorder's ``ef21_*`` / ``randk_*`` operands at 4k bytes
      each, no exchange kernel launched, finite losses, a finite non-zero
      error memory under ef21-topk; step times and peaks printed beside
      phase 4a's; then, at frac 1.0 on a full-width gradient-shaped tree,
      the exchanged mean equal to the gradient bit for bit (and the EF
      memory too), and the top-k selection and the support draw timed
      alone at the full buffer (``sparse_path``);
   g. fault tolerance at the same width (qgenx ``de``, int8 two_phase):
      4 guarded fault-free steps bitwise equal to the same 4 unguarded
      (params after every step; both under deterministic algorithms), then
      6 steps under ``--guard --rollback-after 2 --fault-spec
      "nan_grad@1;wire_corrupt@3-4"`` (steps 1, 3 and 4 rejected, the whole
      state after each bitwise equal to the last good state, one rollback
      to the step-3 snapshot, step 5 finite, kernels 1-3 on the poisoned
      buffer), then 3 guarded ``ef21-topk`` steps with ``nan_grad@1`` (the
      error memory restored bitwise); step times, peaks and the watchdog
      snapshot's bytes and seconds printed (``guard_path``);
   b. the WGAN-GP testbed (``repro_torch.launch.train_gan.run``, the
      paper's Section 5 at the reference's width: K = 3 workers, batch
      256 each, hidden 64) for 300 ExtraAdam steps in each of the fp32,
      uq8, uq4, randk25 and layerwise arms, then uq8 with the device PRNG
      (``wgan.train``).  Kernel 5 (or its device-PRNG variant) must
      launch twice per step in every quantized arm and never in fp32 or
      randk25 (whose bytes a step must be 2 x sum of 8 max(1,
      round(size / 4)) over the leaves);
      every energy distance must be finite and uq8's below the
      reference's bound 2 * fp32 + 0.5 (one seed of the device-PRNG arm
      is reported beside it, not held to the bound).  Each compressed
      arm's first kernel-5 call on the path ([3 x 19, 512]: num_symbols
      (17,) for uq8, (7,) for uq4, (7, 17) for layerwise) is kept, its
      output held bit-equal to the plain version on the same inputs, and
      the kernel timed at that shape (the ``gan-*`` rows of kernel 5: ``ms``
      is the kernel's device time a launch from ``torch.profiler``,
      ``wrapper_ms`` the wrapper's time a call back to back);
   e. the paper's toy-VI testbed (``repro_torch.core.extragradient``
      on ``repro_torch.core.vi`` problems, K = 4, T = 2048 a run): Fig. 4
      (bilinear d = 16, Q-GenX ``de`` fp32 and uq8 against QSGDA) and the
      compression arms on bilinear d = 32 (fp32, uq8, uq4, uq8 with QAda
      every 32 steps; ef21-topk, ef-randk and randk at frac 0.25, which
      launch no kernel), each arm's restricted gap, bits and ms a step
      printed and its gap held to the same draws' run on the CPU port;
      Q-GenX must beat QSGDA, QAda's levels move, and kernel 5 launch 2T
      times per quantized arm; its first call of the uq8 d = 32 arm is
      held to the plain version and timed at that [4 x 64] shape (the
      ``toy-vi-uq8`` row: device time from ``torch.profiler``,
      ``wrapper_ms``) (``toy_vi_path``);
   h. the serving path (``repro_torch.launch.serve`` at the full width of
      tinyllama-1.1b, f32, ``--batch 16 --requests 16 --prompt-len 512
      --gen 128 --page-size 16``; 48 requests before phase 4j, 32 before
      phase 4k, the cut logged as a ``reduced:`` line): ``--kv-bits`` 8, 4
      and 32, each request
      answered, kernel 1 launched 2 x 22 times a wave and a prefill and
      kernel 3 2 x 22 times a wave, the cache >= 2x / >= 4x below fp32, the
      fp32 tokens equal a full forward's argmax but at near ties; one
      request bit-equal alone and packed (tokens and pages); half the
      pages (admission waits); ``--guard`` under three faults (typed
      results, the other requests' tokens the clean run's); the int8
      two_phase logit exchange at K = 1 (kernels 1-3 on the logits);
      then kernels 1 and 3 timed at the cache's shapes (``serve_path``,
      ``serve_kernel_rows``: the ``kv-*`` rows, device and wrapper time);
   i. the other dense families at full width (``archs_train``,
      ``archs_serve``): qwen3-4b (qk-norm, GQA 32 / 8, head_dim 128, vocab
      151936) trained through ``repro_torch.launch.train.run`` at 7 of its
      36 layers (tinyllama's buffer size; the peak below 70 GB), bf16
      layers, 3 qgenx ``de`` int8 two_phase steps (finite losses, the analytic
      ``wire_bytes``, kernels 1-3 six times each); then served through
      ``repro_torch.launch.serve.run``, f32: gemma-2b whole at ``--kv-bits
      8`` and qwen3-4b whole at ``--kv-bits 4`` (16 requests of 512 + 64
      tokens), and gemma3-27b at 12 of its 62 layers (10 local, 2 global)
      at ``--kv-bits mixed`` with 8 prompts of 1536 tokens, past its
      1024-token window (the segments' bits, kernel 1 and 3's launches
      by bits), and 2 requests at ``--kv-bits 32`` whose tokens equal a
      full forward's argmax and whose cached K/V, every layer, equal
      ``forward_with_kv``'s within 1e-4; each cut is logged as a
      ``reduced:`` line.  Kernels 1-3 are then timed at qwen3-4b's buffer
      (the ``qwen3-buffer`` rows) and kernels 1 and 3 at the 1024- and
      2048-feature cache shapes (the ``-f1024`` / ``-f2048`` rows);
   j. the exchange's layouts at tinyllama-1.1b's full width (bf16 layers,
      qgenx ``de``, ``layouts_path``): 3 int8 two_phase steps with
      ``--num-buckets 4 --overlap bucketed`` and 3 with ``defer_tail``
      (kernels 1-3 once per bucket and exchange, ``wire_bytes`` the sum of
      ``bucket_wire_bytes_tree``, the recorder's ``b{i}/`` sums per
      bucket), 2 with ``--no-exchange-plan``, 2 each with
      ``--compress-mode leafwise`` at int8 and int4 (kernels 1 and 4 once
      per leaf and exchange, the leafwise ``wire_bytes``); on a full-width
      gradient-shaped tree, defer_tail's stale tail, the per-call mean bit
      for bit the planned one, and one ``allreduce_fallback`` exchange
      (kernels 1 and 3 once per leaf); then each at reduced size on the
      card against the CPU port (``card_vs_cpu_runs``);
   k. the MoE and VLM families (``families_path``): (a) internvl2-26b
      (d_model 6144, 48 / 8 heads x 128, d_ff 16384, vocab 92553, untied)
      trained through ``repro_torch.launch.train.run`` at full width cut
      to 2 of 48 layers (1,917,431,808 parameters; 1,917,462,528
      exchanged coordinates with the norm scales, so the int8 payload
      stays under 2**31 bytes), bf16 layers, batch 4 x seq 512 with its 256
      stubbed prefix embeds, 3 qgenx ``de`` int8 two_phase steps (finite
      losses, kernels 1-3 twice a step, the analytic ``wire_bytes``; step
      times and peak beside 4a's); (b) llama4 at 5 reduced layers (chunk
      64, 4 experts top-1 and a shared one), the same 3 steps at batch 4
      x 512 on the card and on the CPU port, the same weights, batches
      and noise: every MoE layer's expert choices compared (a flip is
      reported with its token and top-two margin, and fails above a
      1e-5 margin), then losses and params within 1e-6; (c) llama4-maverick-400b-a17b served through
      ``repro_torch.launch.serve.run`` at its published widths cut to
      one period of 4 layers and 16 of 128 experts (Llama-4-Scout's
      count, the config's citation; ``reduced:`` lines), f32, 8 x (512 +
      64) tokens at ``--kv-bits mixed`` (chunk layers int4, the global
      layer int8, the launches by bits) and ``8``, then 2 requests at
      ``--kv-bits 32`` with ``capacity_factor`` = E (no drops, so a
      request's tokens are its own: they equal a full forward's argmax
      but at near ties, and its cached K/V ``forward_with_kv``'s); (d)
      internvl2-26b served at 12 of 48 layers, ``--kv-bits 8``, by its
      tokens; (e) llama4 at 5 reduced layers served at ``mixed`` by
      ``ServeEngine`` on the card and on the CPU port, tokens equal;
5. runs each kernel at its main-path shape (the flat exchange buffer of
   tinyllama-1.1b, 2,148,532 rows x 512): kernels 1, 2, 3 in int8 as
   two_phase chains them, kernels 1 and 4 in int4 as gather does, and
   kernel 5 on the same buffer with one table (qgenx int8) and with the
   layerwise policy's two (int4 above 65536 coordinates, int8 below): the
   ``tinyllama-buffer-*`` rows, a size no path gives kernel 5 (0
   launches; two windows of 10 calls, the second kept).  The device-PRNG
   variants of kernels 1, 2 and 5 run beside their host-noise kernels
   (the ``/prng`` rows), and kernels 1 (int8) and 2 run again on phase
   4d's QAda table (the ``int8-qada`` / ``qada`` rows).
   Kernels 1 and 4 also run at the leafwise exchange's two extreme
   leaves (the ``leafwise-widest`` rows: ``unembed``, 2,048 rows of
   32,000; ``leafwise-most-rows``: the query projection, 1,441,792 rows of
   64), with phase 4j's launches.
   Each output is held against the plain version's on the same inputs
   (payload bytes and kernel 5's estimates exactly equal, f32 within rtol
   1e-6), and each kernel is timed beside its bound and its plain
   version.  Kernels 1 and 5 have a row per variant and shape.
   Kernels 1-3 also run at 4k(a)'s internvl2-26b buffer (3,745,044 x
   512; the plain versions in row chunks) and kernels 1 and 3 at the
   1024-wide cache rows of 4k(c) and 4k(d) (a wave's write [8, 1024], a
   prefill's [512, 1024], a wave's read [8 x 576, 1024]).

The card's line is printed again before the results; the line before
the last is ``{"kernels": [...]}``, the last ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before
either is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2**20  # H100 SXM L2 (NVIDIA data sheet), where the card does not say
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# H100 SXM 32-bit integer rate: 64 INT32 lanes per SM per clock x 132 SMs
# x 1.98 GHz, the boost clock behind the data sheet's 67 TFLOP/s f32
INT32_OPS_PER_S = 64 * 132 * 1.98e9
KERNEL_SOURCE = "src/repro_torch/csrc/exchange_kernels.cu"
REPLACES = {
    "quantize_blocks": "src/repro/kernels/quantize.py:73",
    "dequant_reduce_requantize_blocks": "src/repro/kernels/dequant_reduce.py:136",
    "dequantize_blocks": "src/repro/kernels/dequantize.py:48",
    "dequant_reduce_blocks": "src/repro/kernels/dequant_reduce.py:73",
    "quantize_dequantize_segments": "src/repro/kernels/segment_quantize.py:67",
    # B5, the device-PRNG variants: prng_uniform (kernels/common.py:60) at
    # its call site in each kernel body
    "quantize_blocks/prng": "src/repro/kernels/quantize.py:63",
    "dequant_reduce_requantize_blocks/prng": "src/repro/kernels/dequant_reduce.py:124",
    "quantize_dequantize_segments/prng": "src/repro/kernels/segment_quantize.py:50",
}
PRNG_KERNELS = ("quantize_blocks/prng", "dequant_reduce_requantize_blocks/prng",
                "quantize_dequantize_segments/prng")
GAN_STEPS = 300
# H100 per-SM limits (sm_90): warps, blocks, 32-bit registers (in four
# partitions, allocated per warp in units of 256) and shared memory (1 KB
# of it reserved per block)
SM_WARPS, SM_BLOCKS, SM_REGS, SM_SMEM = 64, 32, 65536, 233472
ROW_KERNEL_THREADS = 256  # kernels 1 and 2: 8 warps a block, one row each
PRNG_SEED = 0x9E3779B97F4A7C15  # the device-PRNG seed of the parity and timing phases
# phase 4a's peaks of device memory at commit 5a288aa, before the step
# computed coded_bits_est (H100 80GB HBM3, 700.00 W)
EARLIER_PEAKS = {"int8": 50_310_774_272, "int8-prng": 50_310_774_272,
              "int4": 49_786_117_632, "layerwise": 48_860_888_064}


def exchanged_coords(cfg) -> int:
    """Coordinates of the gradient tree (``param_count`` leaves out the
    norm scales: two per layer and the final one)."""
    return cfg.param_count() + (2 * cfg.num_layers + 1) * cfg.d_model


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernel parity
# ---------------------------------------------------------------------------


def _rand_payload(torch, gen, K, nb, bucket, s, bits, zero_rows, dev, nan_row=None):
    """K workers' random payloads and norms: all-zero rows at ``zero_rows``
    and, with ``nan_row``, the last worker's norm NaN there (the row's
    K-mean is then NaN throughout)."""
    idx = torch.randint(-(s + 1), s + 2, (K, nb, bucket), generator=gen, device=dev,
                        dtype=torch.int32)
    norms = torch.rand((K, nb), generator=gen, device=dev) * 3 + 0.1
    idx[:, zero_rows] = 0
    norms[:, zero_rows] = 0.0
    if nan_row is not None:
        norms[K - 1, nan_row] = float("nan")
    from repro_torch.kernels.ref import pack_payload

    payload = torch.stack([pack_payload(idx[k], bits) for k in range(K)])
    return payload, norms


def _check_indices(torch, name, got, want, bits, q_is_inf, norms_got, norms_want):
    from repro_torch.kernels.ref import unpack_payload

    if q_is_inf:
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"{name}: {bad} payload bytes differ from the plain version")
        return
    gi = unpack_payload(got, bits)
    wi = unpack_payload(want, bits)
    same_rows = norms_got == norms_want
    if not torch.equal(gi[same_rows], wi[same_rows]):
        fail(f"{name}: indices differ in rows whose L2 norm is bit-identical")
    if int((gi - wi).abs().max()) > 1:
        fail(f"{name}: indices more than one level apart")


def _close(torch, name, got, want, rtol=1e-6):
    """NaN in the same places, every other value within ``rtol``; returns
    the max abs error over the finite-in-both values."""
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        fail(f"{name}: NaN positions differ from the plain version")
    got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    if not torch.allclose(got, want, rtol=rtol, atol=0.0):
        err = float((got - want).abs().max())
        fail(f"{name}: f32 outputs differ beyond rtol {rtol} (max abs err {err:.3e})")
    return float((got - want).abs().max())


def _same(torch, got, want) -> bool:
    """Bit-equal tensors, NaN equal to NaN in the same places."""
    if got.is_floating_point():
        return (torch.equal(got.isnan(), want.isnan())
                and torch.equal(got.nan_to_num(), want.nan_to_num()))
    return torch.equal(got, want)


def wrap_rows(torch) -> int:
    """A row count that makes kernels 1 and 2's grid-stride loop wrap: more
    rows than warps the card can hold at once (64 per SM, one row per
    warp), and not a multiple of the 8 rows of a block."""
    return torch.cuda.get_device_properties(0).multi_processor_count * 64 + 37


def kernel_parity(torch) -> dict:
    """Every kernel vs its plain version on the card; returns the max abs
    error of each kernel's f32 output (dequantized for the payload
    kernels) over all cases."""
    from repro_torch.core.quantization import exponential_levels, uniform_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_reduce import (
        dequant_reduce_blocks,
        dequant_reduce_requantize_blocks,
    )
    from repro_torch.kernels.dequantize import dequantize_blocks
    from repro_torch.kernels.quantize import quantize_blocks

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    errs = {k: 0.0 for k in REPLACES}
    zero_rows, nan_row = [0, 17], 5
    cases = 0
    # 37 rows: not a multiple of any tile; wrap_rows: kernels 1 and 2's
    # grid-stride loop wraps.  Buckets 2 and 1023 (VEC 2 and 1), 130 (a
    # ragged last chunk), 512 (one warp's registers), 1024 (QuantConfig's
    # default) and 4096 (wider than the registers: the second pass).
    # 256: the paged KV-cache's bucket (tinyllama-1.1b's 4 kv heads x 64)
    shapes = [(37, b) for b in (512, 130, 2, 1024, 4096, 256)] + [(37, 1023),
                                                                   (wrap_rows(torch), 512)]
    for bits in (8, 4):
        s = 15 if bits == 8 else 5
        ns = s + 2
        lv = uniform_levels(s, dev)
        for nb, bucket in shapes:
            if bits == 4 and bucket % 2:
                continue
            for q_is_inf in (True, False):
                tag = f"bits={bits} rows={nb} bucket={bucket} q={'inf' if q_is_inf else 2}"
                x = torch.randn((nb, bucket), generator=gen, device=dev) * 3
                x[zero_rows] = 0.0
                x[nan_row, bucket // 2] = float("nan")
                r = torch.rand((nb, bucket), generator=gen, device=dev)
                pk, nk = quantize_blocks(x, r, lv, num_symbols=ns, q_is_inf=q_is_inf,
                                         bits=bits)
                pp, npl = ref.quantize_blocks_plain(x, r, lv, num_symbols=ns,
                                                    q_is_inf=q_is_inf, bits=bits)
                torch.cuda.synchronize()
                _check_indices(torch, f"quantize {tag}", pk, pp, bits, q_is_inf, nk, npl)
                _close(torch, f"quantize norms {tag}", nk, npl)
                if q_is_inf:  # equal payloads and norms: the values agree exactly
                    errs["quantize_blocks"] = max(errs["quantize_blocks"], _close(
                        torch, f"quantize deq {tag}",
                        ref.dequantize_blocks_plain(pk, nk, lv, bits=bits),
                        ref.dequantize_blocks_plain(pp, npl, lv, bits=bits)))
                dk = dequantize_blocks(pk, nk, lv, num_symbols=ns, bits=bits)
                dp = ref.dequantize_blocks_plain(pk, nk, lv, bits=bits)
                errs["dequantize_blocks"] = max(errs["dequantize_blocks"], _close(
                    torch, f"dequantize {tag}", dk, dp))
                cases += 2
                for K in (1, 2, 8):
                    ktag = f"{tag} K={K}"
                    P, N = _rand_payload(torch, gen, K, nb, bucket, s, bits, zero_rows, dev,
                                         nan_row)
                    mk = dequant_reduce_blocks(P, N, lv, num_symbols=ns, num_workers=K,
                                               bits=bits)
                    mp = ref.dequant_reduce_blocks_plain(P, N, lv, bits=bits)
                    errs["dequant_reduce_blocks"] = max(errs["dequant_reduce_blocks"],
                                                        _close(torch, f"dequant_reduce {ktag}",
                                                               mk, mp))
                    r2 = torch.rand((nb, bucket), generator=gen, device=dev)
                    ok_, onk = dequant_reduce_requantize_blocks(
                        P, N, lv, r2, num_symbols=ns, num_workers=K, q_is_inf=q_is_inf,
                        bits=bits)
                    op_, onp = ref.dequant_reduce_requantize_blocks_plain(
                        P, N, lv, r2, num_symbols=ns, q_is_inf=q_is_inf, bits=bits)
                    torch.cuda.synchronize()
                    _check_indices(torch, f"requantize {ktag}", ok_, op_, bits, q_is_inf,
                                   onk, onp)
                    _close(torch, f"requantize norms {ktag}", onk, onp)
                    if q_is_inf:
                        errs["dequant_reduce_requantize_blocks"] = max(
                            errs["dequant_reduce_requantize_blocks"], _close(
                                torch, f"requantize deq {ktag}",
                                ref.dequantize_blocks_plain(ok_, onk, lv, bits=bits),
                                ref.dequantize_blocks_plain(op_, onp, lv, bits=bits)))
                    cases += 2
    # other sorted tables: exponential levels, where s = 15 and 30 put two
    # levels in one of the 256 cells of [0, 1] (kernels 1 and 2 then take
    # the binary search) and s = 5 does not
    nb = 37
    for s, bits in ((15, 8), (30, 8), (5, 4)):
        lv = exponential_levels(s, dev)
        kw = dict(num_symbols=s + 2, bits=bits)
        for q_is_inf in (True, False):
            tag = f"exponential s={s} bits={bits} q={'inf' if q_is_inf else 2}"
            x = torch.randn((nb, 512), generator=gen, device=dev) * torch.exp2(
                torch.randint(-24, 1, (nb, 512), generator=gen, device=dev).float())
            r = torch.rand((nb, 512), generator=gen, device=dev)
            pk, nk = quantize_blocks(x, r, lv, q_is_inf=q_is_inf, **kw)
            pp, npl = ref.quantize_blocks_plain(x, r, lv, q_is_inf=q_is_inf, **kw)
            torch.cuda.synchronize()
            _check_indices(torch, f"quantize {tag}", pk, pp, bits, q_is_inf, nk, npl)
            _close(torch, f"quantize norms {tag}", nk, npl)
            for K in (1, 2):
                P, N = _rand_payload(torch, gen, K, nb, 512, s, bits, zero_rows, dev)
                ok_, onk = dequant_reduce_requantize_blocks(P, N, lv, r, num_workers=K,
                                                            q_is_inf=q_is_inf, **kw)
                op_, onp = ref.dequant_reduce_requantize_blocks_plain(P, N, lv, r,
                                                                      q_is_inf=q_is_inf, **kw)
                torch.cuda.synchronize()
                _check_indices(torch, f"requantize {tag} K={K}", ok_, op_, bits, q_is_inf, onk,
                               onp)
                _close(torch, f"requantize norms {tag} K={K}", onk, onp)
            cases += 3
    # non-finite rows: a NaN / inf coordinate must reach the norm (and so
    # every dequantized value of its row) as in the plain version
    for q_is_inf in (True, False):
        s, bits = 15, 8
        lv = uniform_levels(s, dev)
        x = torch.randn((nb, 512), generator=gen, device=dev)
        x[1, 3], x[6, 200] = float("nan"), float("-inf")
        r = torch.rand((nb, 512), generator=gen, device=dev)
        pk, nk = quantize_blocks(x, r, lv, num_symbols=s + 2, q_is_inf=q_is_inf, bits=bits)
        pp, npl = ref.quantize_blocks_plain(x, r, lv, num_symbols=s + 2, q_is_inf=q_is_inf,
                                            bits=bits)
        dk = dequantize_blocks(pk, nk, lv, num_symbols=s + 2, bits=bits)
        dp = ref.dequantize_blocks_plain(pp, npl, lv, bits=bits)
        torch.cuda.synchronize()
        tag = f"non-finite rows q={'inf' if q_is_inf else 2}"
        _check_indices(torch, tag, pk, pp, bits, q_is_inf, nk, npl)
        if not (torch.equal(nk.isnan(), npl.isnan()) and torch.equal(dk.isnan(), dp.isnan())
                and bool(nk[1].isnan())):
            fail(f"{tag}: NaN does not reach the same norms and values as the plain version")
        cases += 2
    cases += segment_parity(torch, gen, errs)
    cases += prng_parity(torch, gen, errs)
    log(f"phase 3: {cases} kernel-vs-plain cases agree; max abs err {errs}")
    return errs


PHILOX_KAT = [  # Random123's kat_vectors, "philox4x32 10": counter, key -> output
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def prng_parity(torch, gen, errs) -> int:
    """The device-PRNG variants (B5) on the card.  Philox's known answers
    through the test entry that writes raw words (and its words on random
    counters against the plain version's); then kernels 1 (int8, int4),
    2 (K = 1, 2, 8) and 5 drawing their own noise, each held
    bit-equal to the same kernel fed ``philox_uniform``'s draw of the seed
    materialized on the card (payload bytes, norms and estimates, q = inf
    and q = 2: the same arithmetic on the same noise), and to the plain
    version on the CPU (``_check_indices`` / ``_check_segment``); kernel 5
    over ``segment_cases``."""
    from repro_torch.core.quantization import uniform_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_reduce import dequant_reduce_requantize_blocks
    from repro_torch.kernels.prng import philox_words
    from repro_torch.kernels.quantize import quantize_blocks
    from repro_torch.kernels.segment_quantize import quantize_dequantize_segments

    dev = torch.device("cuda")
    ctr = torch.tensor([c for c, _, _ in PHILOX_KAT], dtype=torch.int64)
    key = torch.tensor([k for _, k, _ in PHILOX_KAT], dtype=torch.int64)
    got = philox_words(ctr.to(dev), key.to(dev)).cpu().tolist()
    if got != [list(w) for _, _, w in PHILOX_KAT]:
        fail(f"Philox4x32-10 on the card misses the known answers: {got}")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(5)
    ctr = torch.randint(0, 1 << 32, (4096, 4), generator=cpu_gen, dtype=torch.int64)
    key = torch.randint(0, 1 << 32, (4096, 2), generator=cpu_gen, dtype=torch.int64)
    if not torch.equal(philox_words(ctr.to(dev), key.to(dev)).cpu(), philox_words(ctr, key)):
        fail("Philox4x32-10 on the card differs from the plain version on random counters")
    cases = 2
    zero_rows, nan_row, seed = [0, 17], 5, PRNG_SEED

    def same(name, got, want):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not _same(torch, g, w):
                fail(f"{name}: differs from the host-noise kernel fed the same Philox draw")

    shapes = [(37, b) for b in (512, 130, 2, 1024, 4096)] + [(37, 1023), (wrap_rows(torch), 130)]
    for bits in (8, 4):
        s = 15 if bits == 8 else 5
        lv = uniform_levels(s, dev)
        for nb, bucket in shapes:
            if bits == 4 and bucket % 2:
                continue
            r = ref.philox_uniform(seed, 0, nb, bucket, dev)
            for q_is_inf in (True, False):
                tag = f"bits={bits} rows={nb} bucket={bucket} q={'inf' if q_is_inf else 2}"
                kw = dict(num_symbols=s + 2, q_is_inf=q_is_inf, bits=bits)
                x = torch.randn((nb, bucket), generator=gen, device=dev) * 3
                x[zero_rows] = 0.0
                x[nan_row, bucket // 2] = float("nan")
                pk, nk = quantize_blocks(x, None, lv, seed=seed, **kw)
                same(f"quantize/prng {tag}", (pk, nk), quantize_blocks(x, r, lv, **kw))
                pp, npl = ref.quantize_blocks_plain(x.cpu(), None, lv.cpu(), seed=seed, **kw)
                _check_indices(torch, f"quantize/prng {tag}", pk.cpu(), pp, bits, q_is_inf,
                               nk.cpu(), npl)
                _close(torch, f"quantize/prng norms {tag}", nk.cpu(), npl)
                if q_is_inf:
                    errs["quantize_blocks/prng"] = max(errs["quantize_blocks/prng"], _close(
                        torch, f"quantize/prng deq {tag}",
                        ref.dequantize_blocks_plain(pk.cpu(), nk.cpu(), lv.cpu(), bits=bits),
                        ref.dequantize_blocks_plain(pp, npl, lv.cpu(), bits=bits)))
                cases += 1
                for K in (1, 2, 8):
                    ktag = f"{tag} K={K}"
                    P, N = _rand_payload(torch, gen, K, nb, bucket, s, bits, zero_rows, dev,
                                         nan_row)
                    qk, mk = dequant_reduce_requantize_blocks(P, N, lv, None, num_workers=K,
                                                              seed=seed, **kw)
                    same(f"requantize/prng {ktag}", (qk, mk), dequant_reduce_requantize_blocks(
                        P, N, lv, r, num_workers=K, **kw))
                    qp, mp = ref.dequant_reduce_requantize_blocks_plain(
                        P.cpu(), N.cpu(), lv.cpu(), None, seed=seed, **kw)
                    _check_indices(torch, f"requantize/prng {ktag}", qk.cpu(), qp, bits,
                                   q_is_inf, mk.cpu(), mp)
                    _close(torch, f"requantize/prng norms {ktag}", mk.cpu(), mp)
                    if q_is_inf:
                        errs["dequant_reduce_requantize_blocks/prng"] = max(
                            errs["dequant_reduce_requantize_blocks/prng"], _close(
                                torch, f"requantize/prng deq {ktag}",
                                ref.dequantize_blocks_plain(qk.cpu(), mk.cpu(), lv.cpu(),
                                                            bits=bits),
                                ref.dequantize_blocks_plain(qp, mp, lv.cpu(), bits=bits)))
                    cases += 1
    for case in segment_cases(torch):
        for q_is_inf in (True, False):
            x, _, tables, ns, seg = segment_inputs(torch, gen, case, dev)
            nb, bucket = x.shape
            r = ref.philox_uniform(seed, 0, nb, bucket, dev)
            tag = (f"segment/prng {case[0]} ns={ns if len(ns) < 4 else len(ns)} rows={nb} "
                   f"bucket={bucket} bad={case[3]} q={'inf' if q_is_inf else 2}")
            kw = dict(num_symbols=ns, q_is_inf=q_is_inf)
            got = quantize_dequantize_segments(x, None, tables, seg, seed=seed, **kw)
            same(tag, (got,), (quantize_dequantize_segments(x, r, tables, seg, **kw),))
            want = segment_plain(torch, x.cpu(), None, tables.cpu(), seg.cpu(), case[3],
                                 seed=seed, **kw)
            ties = (x.cpu(), r.cpu(), tables.cpu(), seg.cpu(), ns, True) if nb > 1000 else None
            errs["quantize_dequantize_segments/prng"] = max(
                errs["quantize_dequantize_segments/prng"],
                _check_segment(torch, tag, got.cpu(), want, q_is_inf, ties))
            cases += 1
    log(f"  device PRNG: known answers held, {cases} cases equal the host-noise kernels")
    return cases


# the instructions of a Philox round: 32 x 32 -> 64-bit multiplies and
# three-input xors
ROUND_OPCODES = {"IMAD", "LOP3"}


def philox_int_ops(torch) -> float:
    """32-bit integer operations per coordinate of the device draw: the
    multiplies and xors of the ten rounds in the SASS of ``philox_kernel``
    (the test entry: one Philox4x32-10 call, four draws), over four, plus
    the shift of the 24-bit conversion.  The key schedule's adds are left
    out: the kernels' key is a launch argument, the same for every
    thread, so they need not be per-coordinate work."""
    import collections
    import re
    import shutil

    from repro_torch.kernels import cuda

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        fail("cuobjdump not found (PATH, $CUDA_HOME/bin): the device draw's integer "
             "operations cannot be counted")
    proc = subprocess.run([tool, "-sass", str(cuda.build())], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed: {proc.stderr[-2000:]}")
    counts, func = {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and func is not None:
            counts[func][m.group(1)] += 1
    philox = [f for f in counts if "philox_kernel" in f]
    if len(philox) != 1:
        fail(f"no single philox_kernel in the SASS functions: {sorted(counts)}")
    hist = counts[philox[0]]
    n_int = sum(c for op, c in hist.items() if op.split(".")[0] in ROUND_OPCODES)
    log(f"  philox SASS ({tool}): {sum(hist.values())} instructions, {n_int} multiplies "
        f"and xors; {dict(hist.most_common())}")
    for f in sorted(counts):
        if "quantize_kernel" in f and "Li4ELb0E" in f:  # VEC = 4, int8
            log(f"  SASS {f}: {sum(counts[f].values())} instructions")
    return n_int / 4 + 1


def implied_occupancy(regs: int, smem: int, threads: int = ROW_KERNEL_THREADS) -> tuple:
    """(blocks, warps) resident on one SM for a kernel of ``regs`` registers
    a thread and ``smem`` bytes of static shared memory a block."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 4 * (SM_REGS // 4 // per_warp) // warps
    blocks = min(SM_BLOCKS, SM_WARPS // warps, by_regs, SM_SMEM // (smem + 1024))
    return blocks, blocks * warps


def segment_smem(T: int, s_max: int) -> int:
    """Kernel 5's dynamic shared memory a block: the stacked tables and a
    260-byte cell count per table (``qx_segment_qdq``)."""
    return T * (4 * s_max + 260)


def row_kernel_resources(build_log: str) -> None:
    """Kernels 1, 2 and 5, every instantiation: registers, shared memory and
    spills from the ``-Xptxas=-v`` report, and the occupancy they imply at
    256 threads a block (the grid the launch sizes from the same numbers);
    kernel 5's beside its dynamic shared memory at the GAN path's
    layerwise tables (T = 2, 17 symbols) and at the kernel's maximum
    (T = 32, 128 symbols)."""
    import re

    found, name = {"row": 0, "segment": 0}, None
    spills = (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = (re.search(r"\d(quantize_kernel|dequant_reduce_requantize_kernel)"
                              r"ILi(\d)ELb(\d)ENS_\d+(\w+?Noise)E", m.group(1))
                    or re.search(r"\d(segment_qdq_kernel)ILi(\d)()ENS_\d+(\w+?Noise)E",
                                 m.group(1)))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            regs, smem = int(m.group(1)), int(m.group(2))
            kernel, vec, pack4, noise = name.groups()
            res = f"{regs} registers, {smem} B shared, spills {spills[0]} B stored / " \
                  f"{spills[1]} B loaded"
            if kernel == "segment_qdq_kernel":
                occ = []
                for T, s_max in ((2, 17), (32, 128)):
                    blocks, warps = implied_occupancy(regs, smem + segment_smem(T, s_max))
                    occ.append(f"T={T}, S_max={s_max}: {blocks} blocks x 8 warps = {warps} of "
                               f"{SM_WARPS} warps per SM ({100 * warps / SM_WARPS:.1f} %)")
                log(f"  {kernel}<VEC={vec}, {noise}>: {res} -> {'; '.join(occ)}")
                found["segment"] += 1
            else:
                blocks, warps = implied_occupancy(regs, smem)
                log(f"  {kernel}<VEC={vec}, {'int4' if pack4 == '1' else 'int8'}, {noise}>: "
                    f"{res} -> {blocks} blocks x 8 warps = {warps} of {SM_WARPS} warps per SM "
                    f"({100 * warps / SM_WARPS:.1f} % occupancy)")
                found["row"] += 1
            name = None
    if found != {"row": 20, "segment": 9}:
        fail(f"the ptxas report lists {found} instantiations of kernels 1 and 2 (want 20) "
             "and of kernel 5 (want 9)")


def _check_segment(torch, name, got, want, q_is_inf, ties=None):
    """Kernel 5 vs its plain version: the same NaNs; elsewhere bit-equal for
    q = inf, rtol 1e-6 for q = 2 (the L^2 sum's order); returns the max
    abs error over the finite coordinates.  With ``ties`` (the inputs: x,
    noise, tables, table ids, symbol counts, stochastic), a q = 2 coordinate beyond rtol
    1e-6 must be a rounding tie that the norm's last bit decides
    (``_segment_ties``); it is left out of the comparison."""
    if not torch.equal(got.isnan(), want.isnan()):
        fail(f"{name}: NaN positions differ from the plain version")
    g, w = got.nan_to_num(), want.nan_to_num()
    if q_is_inf and not torch.equal(g, w):
        fail(f"{name}: {int((g != w).sum())} estimates differ from the plain version")
    if ties is not None and not q_is_inf:
        flips = _segment_ties(torch, name, g, w, *ties)
        g, w = g.masked_fill(flips, 0.0), w.masked_fill(flips, 0.0)
    return _close(torch, name, g, w)


TIE = 1e-5  # |xi - draw| (or |xi - 0.5|) under which an ulp of the norm decides


def _segment_ties(torch, name, got, want, x, r, tables, seg, ns, stochastic):
    """The coordinates where kernel 5 and its plain version differ beyond
    rtol 1e-6 at q = 2.  Each must be a tie: the plain version's xi within
    TIE of its draw (of 0.5 with nearest rounding), so that the norm's
    last bit, which the two sum in different orders, decides the rounding,
    and the kernel's value the other end of the plain version's bracket.
    Fails otherwise; returns the mask."""
    from repro_torch.kernels.ref import norm_rows

    flips = ~torch.isclose(got, want, rtol=1e-6, atol=0.0)
    idx = flips.nonzero().tolist()
    if not idx:
        return flips
    norms = norm_rows(x.float(), False)
    for i, j in idx:
        t = int(seg[i])
        lv = tables[t]
        norm = float(norms[i])
        u = min(max(abs(float(x[i, j])) / (norm if norm > 0 else 1.0), 0.0), 1.0)
        tau = int((lv[1:ns[t] - 1] <= u).sum())  # the interior levels' compares
        lo, hi = float(lv[tau]), float(lv[tau + 1])
        xi = (u - lo) / (hi - lo)
        edge = float(r[i, j]) if stochastic else 0.5
        ends = {lo * norm, hi * norm}
        if abs(xi - edge) > TIE or not any(
                math.isclose(abs(float(got[i, j])), e, rel_tol=1e-5) for e in ends):
            fail(f"{name}: estimate ({i}, {j}) {float(got[i, j])!r} differs from the plain "
                 f"version's {float(want[i, j])!r} and is no tie (xi {xi!r}, draw {edge!r})")
    log(f"  {name}: {len(idx)} rounding ties taken the other way (q = 2: the norm's last bit)")
    return flips


def segment_tables(torch, name, dev):
    """Kernel 5's stacked level tables of one case: the first T of 17, 7 and
    5 symbols (``T1``, ``T2``, ``T3``); 32 tables of 2-128 symbols, uniform
    (the cell lookup) and exponential (the binary search), the kernel's
    maximum T (``T32``); or a 128-symbol exponential table beside a
    128-symbol uniform one (``exp128``)."""
    from repro_torch.core.exchange_plan import stack_level_tables
    from repro_torch.core.quantization import exponential_levels, uniform_levels

    if name == "T32":
        return stack_level_tables(
            [uniform_levels(s, dev) for s in (0, 1, 2, 3, 5, 7, 10, 15, 20, 31, 40, 63, 64,
                                              100, 125, 126)]
            + [exponential_levels(s, dev) for s in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 15, 20,
                                                    30, 60, 126)])
    if name == "exp128":
        return stack_level_tables([exponential_levels(126, dev), uniform_levels(126, dev)])
    return stack_level_tables([uniform_levels(15, dev), uniform_levels(5, dev),
                               exponential_levels(3, dev)][:int(name[1:])])


def segment_cases(torch) -> list:
    """Kernel 5's parity cases (tables, rows, bucket, rows given a table id
    outside [0, T)): T = 1, 2, 3 at buckets 512, 130 (VEC 2) and 37 (VEC
    1); T = 32; the 128-symbol tables; buckets 1024 (four chunks a warp)
    and 1023; more rows than the card holds warps (each warp strides); two
    rows with table ids -1 and T."""
    old = [(f"T{T}", 37, b, ()) for T in (1, 2, 3) for b in (512, 130, 37)]
    return old + [("T32", 101, 512, ()), ("exp128", 37, 512, ()), ("T3", 37, 1024, ()),
                  ("T3", 37, 1023, ()), ("T2", wrap_rows(torch), 512, ()),
                  ("T3", 37, 512, (3, 20))]


def segment_inputs(torch, gen, case, dev):
    """x with zero rows 0 and 17 and a NaN in row 5, uniform noise, the
    tables and random table ids (the case's bad rows given -1 and T)."""
    name, nb, bucket, bad = case
    tables, ns = segment_tables(torch, name, dev)
    x = torch.randn((nb, bucket), generator=gen, device=dev) * 3
    x[[0, 17]] = 0.0
    x[5, bucket // 2] = float("nan")
    r = torch.rand((nb, bucket), generator=gen, device=dev)
    seg = torch.randint(0, len(ns), (nb,), generator=gen, device=dev, dtype=torch.int32)
    seg[list(bad)] = torch.tensor([-1, len(ns)], dtype=torch.int32, device=dev)[:len(bad)]
    return x, r, tables, ns, seg


def segment_plain(torch, x, r, tables, seg, bad, **kw):
    """The plain version, NaN over the rows whose table id is out of range
    (the plain version takes no such id: it is given table 0 there)."""
    from repro_torch.kernels import ref

    want = ref.quantize_dequantize_segments_plain(
        x, r, tables, seg.clamp(0, tables.shape[0] - 1), **kw)
    want[list(bad)] = float("nan")
    return want


def segment_parity(torch, gen, errs) -> int:
    """Kernel 5 against its plain version at small shapes (``segment_cases``),
    with host noise and with nearest rounding."""
    from repro_torch.kernels.segment_quantize import quantize_dequantize_segments

    dev = torch.device("cuda")
    cases = 0
    for case in segment_cases(torch):
        for q_is_inf in (True, False):
            for stochastic in (True, False):
                x, r, tables, ns, seg = segment_inputs(torch, gen, case, dev)
                tag = (f"segment {case[0]} ns={ns if len(ns) < 4 else len(ns)} rows={case[1]} "
                       f"bucket={case[2]} bad={case[3]} q={'inf' if q_is_inf else 2} "
                       f"{'stochastic' if stochastic else 'nearest'}")
                kw = dict(num_symbols=ns, q_is_inf=q_is_inf, stochastic=stochastic)
                got = quantize_dequantize_segments(x, r if stochastic else None, tables, seg,
                                                   **kw)
                want = segment_plain(torch, x, r, tables, seg, case[3], **kw)
                torch.cuda.synchronize()
                if not bool(got[5].isnan().all()) or bool((got[[0, 17]] != 0).any()):
                    fail(f"{tag}: the NaN row or the zero rows are wrong")
                ties = (x, r, tables, seg, ns, stochastic) if case[1] > 1000 else None
                errs["quantize_dequantize_segments"] = max(
                    errs["quantize_dequantize_segments"],
                    _check_segment(torch, tag, got, want, q_is_inf, ties))
                cases += 1
    return cases


# ---------------------------------------------------------------------------
# phase 4: the train path
# ---------------------------------------------------------------------------


def _train_args(**kw):
    from repro_torch.launch.train import parser

    argv = []
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return parser().parse_args(argv)


def tinyllama_leaf_shapes(torch) -> list:
    """Leaf shapes of tinyllama-1.1b at full width, in JAX flatten order
    (the exchange's leaf order), from a model built once on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build

    model = build(get_config("tinyllama-1.1b"), device="cuda")
    shapes = [tuple(p.shape) for p in model.param_leaves()]
    del model
    torch.cuda.empty_cache()
    return shapes


def train_path(torch, batch: int, seq: int, shapes: list) -> dict:
    """The LM path at full width, run by run, with the launch counts reset
    just before each run and read just after: qgenx ``de`` int8 two_phase
    with host noise, the same with the device PRNG
    (``ExchangeConfig(use_device_prng=True)``, given to ``run`` as the
    exchange: the CLI has no flag for it, as in the reference), qgenx
    ``optda`` int4 gather and extra_adam layerwise.  Returns, per run, its
    launch counts, step times and peak device memory."""
    from repro_torch.core.exchange import make_exchange
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import build_exchange_config, run

    de_int8 = dict(optimizer="qgenx", method="de", compression="int8",
                   compress_mode="two_phase", steps=3)
    runs = [
        ("int8", 2, de_int8, False),
        ("int8-prng", 2, de_int8, True),
        ("int4", 1, dict(optimizer="qgenx", method="optda", compression="int4",
                         compress_mode="gather", steps=2), False),
        ("layerwise", 2, dict(optimizer="extra_adam", compressor="layerwise",
                              compression="int4", compress_mode="two_phase", steps=2), False),
    ]
    host_only = ("quantize_blocks", "dequant_reduce_requantize_blocks")
    by_run = {}
    for tag, calls, spec, prng in runs:
        args = _train_args(arch="tinyllama-1.1b", dtype="bfloat16", batch=batch, seq=seq,
                           device="cuda", **spec)
        ex_cfg = dataclasses.replace(build_exchange_config(args), use_device_prng=prng)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        out = run(args, log=lambda m: log(f"  {m}"), exchange=ex_cfg)
        counts = cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ex = make_exchange(ex_cfg)
        want_wire = calls * ex.compressor.wire_bytes_tree(shapes, 1, ex.cfg)
        if not all(math.isfinite(v) for v in out["loss"]):
            fail(f"non-finite loss in {tag} {spec}: {out['loss']}")
        if any(w != want_wire for w in out["wire_bytes"]):
            fail(f"wire_bytes {out['wire_bytes']} != analytic {want_wire} in {tag} {spec}")
        stray = [k for k in (host_only if prng else PRNG_KERNELS) if counts[k]]
        if stray:
            fail(f"LM run {tag} launched {stray}: {counts}")
        coded = out["coded_bits_est"]
        if ex_cfg.compressor == "qgenx" and not all(0 < c <= 8 * calls * compress_bytes(
                ex, shapes) for c in coded):
            fail(f"coded_bits_est {coded} outside (0, 8 x the payload bytes] in {tag}")
        by_run[tag] = {"counts": counts, "step_s": out["step_s"], "peak_bytes": peak}
        log(f"  {spec['optimizer']} {tag} {spec['compress_mode']}: "
            f"loss={out['loss']} wire_bytes={out['wire_bytes'][0]:.0f} coded_bits_est={coded} "
            f"step_s={out['step_s']} peak_bytes={peak} (5a288aa: {EARLIER_PEAKS[tag]}, "
            f"{(peak - EARLIER_PEAKS[tag]) / 2**30:+.3f} GiB) launches={counts}")
    lm_kernels = [k for k in cuda.KERNELS
                  if k not in ("quantize_dequantize_segments", "philox")
                  and k != "quantize_dequantize_segments/prng"]
    missing = [k for k in lm_kernels if not any(r["counts"][k] for r in by_run.values())]
    if missing:
        fail(f"kernels never launched on the LM path: {missing}")
    host, prng = by_run["int8"], by_run["int8-prng"]
    log(f"phase 4a: de int8 two_phase, host noise vs device PRNG: step_s {host['step_s']} vs "
        f"{prng['step_s']}; peak device memory {host['peak_bytes']} vs {prng['peak_bytes']} "
        f"bytes ({(host['peak_bytes'] - prng['peak_bytes']) / 1e9:.3f} GB less)")
    return by_run


def compress_bytes(ex, shapes) -> float:
    """``compress_wire_bytes_tree`` of a gradient with these leaf shapes:
    the payload bytes one worker's fixed-width broadcast pays for."""
    return ex.plan_for(shapes, "compress", 1).compress_payload_bytes()


# ---------------------------------------------------------------------------
# phase 4c: the local-update regime, the coded-bits metric and checkpoints
# ---------------------------------------------------------------------------


LOCAL_STEPS, SYNC_EVERY, RECENTER_EVERY, CKPT_EVERY = 4, 2, 4, 2
RESUME_LOSS_RTOL = 1e-6  # see local_update_path
# phase 4c's depth: its time is the checkpoints' I/O (five 11.3 GB saves
# and restores at ~37 s each at 22 layers); cut to 10 of 22 layers so the
# whole script keeps its time with phases 4h and 4i (full width) added
# (~226 s at 16 layers, 162.5-177.9 s at 10 on an H100 80GB HBM3), and to 6
# with phase 4k
LOCAL_UPDATE_LAYERS = 6


def _leaf_crcs(trees) -> dict:
    """crc32 of each leaf of each named tree, as a checkpoint records it."""
    import zlib

    from repro_torch.checkpoint import checkpointing

    return {name: {k: zlib.crc32(checkpointing._to_host(v).tobytes())
                   for k, v in checkpointing._flatten_with_paths(tree).items()}
            for name, tree in trees.items()}


def _leaves(torch, cfg) -> list:
    """(shape, dtype) of each parameter leaf at this config, in JAX order,
    from a model built once on the card."""
    from repro_torch.models.model import build

    model = build(cfg, device="cuda")
    out = [(tuple(p.shape), p.dtype) for p in model.param_leaves()]
    del model
    torch.cuda.empty_cache()
    return out


def local_update_path(torch, batch: int, seq: int) -> dict:
    """Phase 4c: tinyllama-1.1b at full width (bf16 layers, K = 1) through
    ``run()``: qgenx ``de``, int8 two_phase, host noise, ``sync_every=2``,
    ``recenter_every=4``, 4 steps, a checkpoint every 2 steps into
    ``build/chip_smoke_ckpt`` (deleted afterwards), with the wire recorder
    on.  Holds: ``wire_bytes`` 0 on the local steps (0 and 2) and, on the
    sync steps, the analytic bytes of the exchanges that ran (2 at step 1;
    2 and the re-centering one at step 3) plus the 16,384 probe bytes,
    the run's total equal to the recorder's; ``param_drift`` exactly 0;
    ``coded_bits_est`` 0 on local steps and in (0, 2 x 8 x the payload
    bytes] on sync steps; kernels 1-3 launched once per exchange.  Then
    restores the step-2 checkpoint into a fresh model on the card (every
    leaf crc-equal to the saved one) and resumes a second run there: its
    steps 2-3 losses within rtol ``RESUME_LOSS_RTOL`` of the first run's:
    the same state, batch and noise, but the embedding's backward
    (``index_put_`` with accumulate) carries no determinism promise on
    CUDA, so bit-equality is printed, not required.  Prints each save's and restore's bytes
    and seconds, the cost of one ``coded_bits_tree`` at this gradient,
    step times and peak memory.  Returns the first run's launch counts."""
    import shutil

    from repro_torch.checkpoint import checkpointing
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import make_exchange, wire_trace_start, wire_trace_stop
    from repro_torch.core.exchange_plan import size_of
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import build_exchange_config, restore_checkpoint, run, \
        state_trees
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers as opt
    from repro_torch.optim.optimizers import OptimizerConfig

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = os.path.join(here, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="bfloat16",
                              num_layers=LOCAL_UPDATE_LAYERS)
    free = shutil.disk_usage(ckpt_dir).free
    # at most 12 bytes a coordinate (f32 params, anchor and dual
    # accumulator); two checkpoints on disk at once and a write's margin
    need = lambda c: 2.5 * 12 * exchanged_coords(c)  # noqa: E731
    while need(cfg) > free and cfg.num_layers > 1:
        cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
    if cfg.num_layers < get_config("tinyllama-1.1b").num_layers:
        log(f"  reduced: phase 4c tinyllama-1.1b num_layers 22 -> {cfg.num_layers} (the "
            f"script's time, for phase 4k; {free} bytes free on the checkout's disk)")
    if need(cfg) > free:
        fail(f"phase 4c: {free} bytes free, two checkpoints need {need(cfg) / 1.25:.0f}")
    leaves = _leaves(torch, cfg)
    shapes = [s for s, _ in leaves]
    args = _train_args(arch="tinyllama-1.1b", dtype="bfloat16", batch=batch, seq=seq,
                       device="cuda", optimizer="qgenx", method="de", compression="int8",
                       compress_mode="two_phase", steps=LOCAL_STEPS, sync_every=SYNC_EVERY,
                       recenter_every=RECENTER_EVERY, checkpoint_dir=ckpt_dir,
                       checkpoint_every=CKPT_EVERY)
    ex = make_exchange(build_exchange_config(args))
    sizes = [size_of(s) for s in shapes]
    per_call = ex.compressor.wire_bytes_tree(shapes, 1, ex.cfg)
    probe = 4.0 * min(ex.cfg.drift_probe, sum(sizes))
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        wire_trace_start()
        first = run(args, log=lambda m: log(f"  {m}"), config=cfg)
        trace = wire_trace_stop()
        counts = cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        calls = [0, 2, 0, 3]  # exchanges per step: sync at 1 and 3, re-center at 3
        want_wire = [c * per_call + (probe if c else 0.0) for c in calls]
        if first["wire_bytes"] != want_wire:
            fail(f"phase 4c wire_bytes {first['wire_bytes']} != analytic {want_wire}")
        if sum(b for _, b in trace) != sum(first["wire_bytes"]):
            fail(f"phase 4c: the recorder's {sum(b for _, b in trace)} bytes != "
                 f"wire_bytes {sum(first['wire_bytes'])}")
        if [n for n, _ in trace].count("drift_probe") != 2:
            fail(f"phase 4c: the recorder saw {[n for n, _ in trace]}")
        if any(d != 0.0 for d in first["param_drift"]):
            fail(f"phase 4c param_drift {first['param_drift']} is not 0 at K = 1")
        bound = 2 * 8 * compress_bytes(ex, shapes)
        coded = first["coded_bits_est"]
        if coded[0] or coded[2] or not all(0 < coded[t] <= bound for t in (1, 3)):
            fail(f"phase 4c coded_bits_est {coded} (bound {bound} on sync steps)")
        if not all(math.isfinite(v) for v in first["loss"]):
            fail(f"phase 4c: non-finite loss {first['loss']}")
        exchanges = sum(calls)
        want_counts = {k: (exchanges if k in ("quantize_blocks",
                                              "dequant_reduce_requantize_blocks",
                                              "dequantize_blocks") else 0)
                       for k in cuda.KERNELS}
        if counts != want_counts:
            fail(f"phase 4c launches {counts} != {want_counts}")
        for sv in first["saves"]:
            log(f"  phase 4c save: step {sv['step']}, {sv['bytes']} bytes, "
                f"{sv['seconds']:.2f} s")
        log(f"  phase 4c: loss={first['loss']} wire_bytes={first['wire_bytes']} "
            f"param_drift={first['param_drift']} coded_bits_est={coded} "
            f"step_s={first['step_s']} peak_bytes={peak} launches={counts}")

        # the step-2 checkpoint, restored into a fresh model on the card
        for name in ("ckpt_4.npz", "ckpt_4.meta"):
            os.remove(os.path.join(ckpt_dir, name))
        with open(os.path.join(ckpt_dir, "latest"), "w") as f:
            f.write(str(CKPT_EVERY))
        gc.collect()
        torch.cuda.empty_cache()
        model = build(cfg, seed=args.seed + 1, device="cuda")
        opt_cfg = OptimizerConfig(name="qgenx", method="de", gamma_scale=args.gamma_scale)
        opt_state = opt.init_state(opt_cfg, model.param_leaves())
        opt_state, ex_state, info = restore_checkpoint(
            args, model, opt_state, ex.init_state("cuda"), torch.device("cuda"),
            log=lambda m: log(f"  {m}"))
        meta = checkpointing.read_meta(ckpt_dir, CKPT_EVERY)
        got = _leaf_crcs(state_trees(model, opt_state, ex_state))
        bad = [(n, k) for n in got for k in got[n] if got[n][k] != meta["trees"][n]["crc32"][k]]
        if bad or sorted(got) != sorted(meta["trees"]):
            fail(f"phase 4c: restored leaves differ from the checkpoint's: {bad[:5]}")
        log(f"  phase 4c restore: step {info['step']}, {info['bytes']} bytes, "
            f"{info['seconds']:.2f} s; {sum(len(v) for v in got.values())} leaves crc-equal")
        del model, opt_state, ex_state
        gc.collect()
        torch.cuda.empty_cache()

        # resume: steps 2-3 again from the step-2 checkpoint
        second = run(args, log=lambda m: log(f"  {m}"), config=cfg)
        if second["start_step"] != CKPT_EVERY:
            fail(f"phase 4c: the second run started at {second['start_step']}")
        log(f"  phase 4c resume restore: {second['restored']}")
        a, b = first["loss"][CKPT_EVERY:], second["loss"]
        worst = max(abs(x - y) / abs(x) for x, y in zip(a, b))
        if len(b) != len(a) or worst > RESUME_LOSS_RTOL:
            fail(f"phase 4c: resumed losses {b} vs {a} (rtol {worst:.3e})")
        if second["wire_bytes"] != want_wire[CKPT_EVERY:]:
            fail(f"phase 4c: resumed wire_bytes {second['wire_bytes']}")
        log(f"  phase 4c resumed losses {b} vs {a}: rel diff {worst:.3e} "
            f"(rtol {RESUME_LOSS_RTOL}); step_s {second['step_s']}")

        # the cost of coded_bits_est: one coded_bits_tree at this gradient
        g = [torch.randn(s, device="cuda", dtype=torch.float32).to(dt) for s, dt in leaves]
        st = ex.init_state("cuda")
        ms, val = _time_ms(torch, lambda: ex.coded_bits_tree(g, st), 3)
        log(f"  phase 4c: coded_bits_tree at the gradient ({sum(sizes)} coordinates): "
            f"{ms:.2f} ms a call, {float(val):.6e} bits")
        del g
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"phase 4c: {cfg.num_layers} layers, sync step {first['step_s'][1]:.3f} / "
        f"{first['step_s'][3]:.3f} s, local step {first['step_s'][0]:.3f} / "
        f"{first['step_s'][2]:.3f} s, peak {peak} bytes, coded_bits_tree {ms:.2f} ms")
    return counts


# ---------------------------------------------------------------------------
# phase 4d: QAda adaptive levels on the main-path exchange
# ---------------------------------------------------------------------------


QADA_STEPS, QADA_EVERY = 4, 2


def bracket_branch(torch, levels) -> str:
    """The bracket search kernels 1 and 2 take for this table: ``binary
    search`` when an open cell (c, c + 1) / 256 of [0, 1] holds two interior
    levels (``stage_tables`` in the CUDA source), else ``cell lookup``."""
    interior = levels.detach().float().cpu()[1:-1]
    for c in range(257):
        lo = torch.tensor(c / 256, dtype=torch.float32)
        hi = torch.tensor((c + 1) / 256, dtype=torch.float32)
        if int((interior < hi).sum()) - int((interior <= lo).sum()) > 1:
            return "binary search"
    return "cell lookup"


def qada_path(torch, batch: int, seq: int, shapes: list, fixed: dict) -> dict:
    """Phase 4d: tinyllama-1.1b at full width (bf16 layers, K = 1) through
    ``run()``: qgenx ``de``, int8 two_phase, host noise,
    ``--level-schedule qada --level-update-every 2``, 4 steps (8 exchange
    calls, 4 refreshes), the wire recorder on.  Holds: 8 calls counted
    (``ExchangeState.step``); the final table moved from uniform, valid
    (ends 0 and 1, strictly increasing); ``wire_bytes`` each step 2 x (the
    analytic bytes + the histogram's 2048); the recorder's total equal and
    ``qada_hist`` recorded once a call; kernels 1-3 once a call, no other;
    finite losses; kernels 1 and 2 on the run's last table bit-equal to
    their plain versions (q = inf) on 4096 rows.  The histogram pass
    (``Exchange._tree_hist``) and each refresh (the host solve) are timed
    with a device sync on both sides.  Prints the step times beside phase
    4a's fixed-schedule run (``fixed``), the pass's and the refresh's ms
    and the peak memory.  Returns the launch counts and the table."""
    import numpy as np

    from repro_torch.core import exchange as xmod
    from repro_torch.core.exchange import make_exchange, wire_trace_start, wire_trace_stop
    from repro_torch.core.quantization import uniform_levels, validate_levels
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.dequant_reduce import dequant_reduce_requantize_blocks
    from repro_torch.kernels.quantize import quantize_blocks
    from repro_torch.launch.train import build_exchange_config, run

    args = _train_args(arch="tinyllama-1.1b", dtype="bfloat16", batch=batch, seq=seq,
                       device="cuda", optimizer="qgenx", method="de", compression="int8",
                       compress_mode="two_phase", steps=QADA_STEPS, level_schedule="qada",
                       level_update_every=QADA_EVERY)
    ex_cfg = build_exchange_config(args)
    ex = make_exchange(ex_cfg)
    per_call = ex.compressor.wire_bytes_tree(shapes, 1, ex_cfg) + 4 * ex_cfg.qada_bins
    hist_ms, solve_ms, states = [], [], []
    tree_hist, solve, advance = xmod.Exchange._tree_hist, xmod._qada_solve, xmod.Exchange._advance

    def timed(fn, into):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def recording_advance(self, state, *args, **kw):
        out = advance(self, state, *args, **kw)
        states.append(out)
        return out

    xmod.Exchange._tree_hist = timed(tree_hist, hist_ms)
    xmod._qada_solve = timed(solve, solve_ms)
    xmod.Exchange._advance = recording_advance
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        wire_trace_start()
        out = run(args, log=lambda m: log(f"  {m}"), exchange=ex_cfg)
        trace = wire_trace_stop()
        counts = cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        xmod.Exchange._tree_hist, xmod._qada_solve, xmod.Exchange._advance = \
            tree_hist, solve, advance
    calls = 2 * QADA_STEPS
    last = states[-1]
    if last.step != calls or len(states) != calls:
        fail(f"phase 4d: ExchangeState.step {last.step} after {len(states)} calls, "
             f"expected {calls}")
    lv = last.levels
    validate_levels(lv, ex_cfg.quant.num_levels)
    uniform = uniform_levels(ex_cfg.quant.num_levels, lv.device)
    if torch.allclose(lv, uniform, atol=1e-4) or out["levels"] != lv.tolist():
        fail(f"phase 4d: the table did not move from uniform, or run() returned another: "
             f"{lv.tolist()} vs {out['levels']}")
    if out["wire_bytes"] != [2 * per_call] * QADA_STEPS:
        fail(f"phase 4d wire_bytes {out['wire_bytes']} != 2 x {per_call} a step")
    names = [n for n, _ in trace]
    if sum(b for _, b in trace) != sum(out["wire_bytes"]) or names.count("qada_hist") != calls:
        fail(f"phase 4d: the recorder saw {names} ({sum(b for _, b in trace)} bytes)")
    want_counts = {k: (calls if k in ("quantize_blocks", "dequant_reduce_requantize_blocks",
                                      "dequantize_blocks") else 0) for k in cuda.KERNELS}
    if counts != want_counts:
        fail(f"phase 4d launches {counts} != {want_counts}")
    if not all(math.isfinite(v) for v in out["loss"]):
        fail(f"phase 4d: non-finite loss {out['loss']}")
    if len(solve_ms) != calls // QADA_EVERY or len(hist_ms) != calls:
        fail(f"phase 4d: {len(solve_ms)} refreshes and {len(hist_ms)} histogram passes")
    # kernels 1 and 2 on the run's table, against their plain versions
    s = ex_cfg.quant.num_levels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    x = torch.randn((4096, 512), generator=gen, device="cuda")
    r = torch.rand((4096, 512), generator=gen, device="cuda")
    kw = dict(num_symbols=s + 2, q_is_inf=True, bits=8)
    pk, nk = quantize_blocks(x, r, lv, **kw)
    pp, np_ = ref.quantize_blocks_plain(x, r, lv, **kw)
    P, N = pp.unsqueeze(0), np_.unsqueeze(0)
    got = dequant_reduce_requantize_blocks(P, N, lv, r, num_workers=1, **kw)
    want = ref.dequant_reduce_requantize_blocks_plain(P, N, lv, r, **kw)
    if not (torch.equal(pk, pp) and torch.equal(nk, np_) and torch.equal(got[0], want[0])
            and torch.equal(got[1], want[1])):
        fail("phase 4d: kernels 1 / 2 on the QAda table differ from their plain versions")
    branch = bracket_branch(torch, lv)
    log(f"  phase 4d: loss={out['loss']} wire_bytes={out['wire_bytes'][0]:.0f} "
        f"step_s={out['step_s']} peak_bytes={peak} launches={counts}")
    log(f"  phase 4d: final table {np.round(np.asarray(lv.tolist()), 6).tolist()}; kernels 1 "
        f"and 2 on it bit-equal to their plain versions ({branch})")
    log(f"phase 4d: qada de int8 two_phase step_s {out['step_s']} vs fixed {fixed['step_s']}; "
        f"histogram pass {hist_ms} ms a call (median {sorted(hist_ms)[len(hist_ms) // 2]:.2f}); "
        f"refresh {solve_ms} ms; peak {peak} bytes (fixed: {fixed['peak_bytes']})")
    return {"counts": counts, "levels": lv, "branch": branch, "step_s": out["step_s"],
            "hist_ms": hist_ms, "solve_ms": solve_ms}


# ---------------------------------------------------------------------------
# phase 4f: the sparse compressors (ef21-topk, randk) on the main path
# ---------------------------------------------------------------------------


SPARSE_STEPS, SPARSE_FRAC = 3, 0.25
SPARSE_RUNS = (("ef21-topk", dict(ef_topk_frac=SPARSE_FRAC), "ef21"),
               ("randk", dict(rand_frac=SPARSE_FRAC), "randk"))


def _synced_ms(torch, fn):
    """(fn's result, its ms with a device sync on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sparse_path(torch, batch: int, seq: int, shapes: list, fixed: dict) -> dict:
    """Phase 4f: tinyllama-1.1b at full width (bf16 layers, K = 1) through
    ``run()``: 3 qgenx ``de`` steps under ``--compressor ef21-topk
    --ef-topk-frac 0.25``, then under ``--compressor randk --rand-frac
    0.25``, the launch counts reset and the wire recorder on around each
    run.  Holds: ``wire_bytes`` 2 x 8k a step (k = round(0.25 n), two
    exchanges); the recorder's ``<tag>_vals`` / ``<tag>_idx`` at 4k bytes
    each, once an exchange; no exchange kernel launched (the sparse
    compressors run none); finite losses; under ef21-topk a finite,
    non-zero ``[1, n]`` error memory.  Then two exact checks at frac 1.0
    on a full-width gradient-shaped tree (one exchange each, from a zero
    memory): under ef21-topk h' = 0 + (g - 0) = g, so the mean and the
    memory equal g; under randk the support is everything and n/k = 1, so
    the mean equals g.  Last, the top-k selection and the support draw
    are timed alone at the full buffer (k = round(0.25 n), synced, two
    calls each).  Prints step times beside phase 4a's qgenx int8 run
    (``fixed``), peaks, wire bytes and the recorder's list.  Returns the
    launch counts."""
    from repro_torch.core import exchange as xmod
    from repro_torch.core.exchange import ExchangeConfig, make_exchange, topk_support
    from repro_torch.core.exchange_plan import size_of
    from repro_torch.core.noise import GeneratorNoise
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import run

    n = sum(size_of(s) for s in shapes)
    k = max(1, round(SPARSE_FRAC * n))
    counts_all = {name: 0 for name in cuda.KERNELS}
    peaks = {}
    for comp, frac, tag in SPARSE_RUNS:
        args = _train_args(arch="tinyllama-1.1b", dtype="bfloat16", batch=batch, seq=seq,
                           device="cuda", optimizer="qgenx", method="de", compressor=comp,
                           steps=SPARSE_STEPS, **frac)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        xmod.wire_trace_start()
        out = run(args, log=lambda m: log(f"  {m}"))
        trace = xmod.wire_trace_stop()
        counts = cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        peaks[comp] = peak
        err = out.pop("ex_state").error
        want_wire = 2 * 8.0 * k
        if out["wire_bytes"] != [want_wire] * SPARSE_STEPS:
            fail(f"phase 4f {comp}: wire_bytes {out['wire_bytes']} != 2 x 8k = {want_wire}")
        if trace != [(f"{tag}_vals", 4 * k), (f"{tag}_idx", 4 * k)] * (2 * SPARSE_STEPS):
            fail(f"phase 4f {comp}: the recorder saw {trace[:4]}... ({len(trace)} entries)")
        if any(counts.values()):
            fail(f"phase 4f {comp}: exchange kernels launched: {counts}")
        if not all(math.isfinite(v) for v in out["loss"]):
            fail(f"phase 4f {comp}: non-finite loss {out['loss']}")
        norm = float(torch.linalg.vector_norm(err))
        want_shape = (1, n) if comp == "ef21-topk" else (1,)
        if tuple(err.shape) != want_shape or not math.isfinite(norm) or (
                comp == "ef21-topk" and norm == 0.0):
            fail(f"phase 4f {comp}: error memory {tuple(err.shape)}, norm {norm}")
        del err
        log(f"  phase 4f {comp} (frac {SPARSE_FRAC}): loss={out['loss']} step_s={out['step_s']} "
            f"peak_bytes={peak} wire_bytes={out['wire_bytes'][0]:.0f} (2 x 8k, k = {k}) "
            f"recorder={trace[:2]} x {SPARSE_STEPS * 2} error_norm={norm!r} launches=0")
        log(f"phase 4f: de {comp} step_s {out['step_s']} vs qgenx int8 {fixed['step_s']}; "
            f"peak {peak} bytes (qgenx int8: {fixed['peak_bytes']})")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # the exact checks at frac = 1.0, one exchange each from a zero memory
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    tree = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    for comp in ("ef21-topk", "randk"):
        ex = make_exchange(ExchangeConfig(compressor=comp, rand_frac=1.0, ef_topk_frac=1.0))
        st = ex.init_state("cuda", template=tree, num_workers=1)
        (mean, st), ms = _synced_ms(torch, lambda: ex.pmean_tree(
            tree, st, GeneratorNoise.seeded(44, "cuda")))
        if not all(torch.equal(m, g) for m, g in zip(mean, tree)):
            fail(f"phase 4f: {comp} at frac 1.0: the mean is not the gradient bit for bit")
        if comp == "ef21-topk" and not all(
                torch.equal(st.error[0, o: o + g.numel()], g.reshape(-1))
                for o, g in zip(_offsets(tree), tree)):
            fail("phase 4f: ef21-topk at frac 1.0: the memory is not the gradient")
        log(f"  phase 4f: {comp} at frac 1.0 over {n} coordinates: mean == g bit for bit"
            + (", error == g" if comp == "ef21-topk" else "") + f" ({ms:.1f} ms the exchange)")
        del mean, st, ex
    del tree
    gc.collect()
    torch.cuda.empty_cache()

    # the two selections alone, at the full buffer
    x = torch.randn((n,), generator=gen, device="cuda")
    noise = GeneratorNoise.seeded(45, "cuda")
    topk_ms, draw_ms = [], []
    for _ in range(2):
        idx, ms = _synced_ms(torch, lambda: topk_support(x, k))
        topk_ms.append(ms)
        if idx.numel() != k:
            fail(f"phase 4f: topk_support gave {idx.numel()} indices, not {k}")
        del idx
        idx, ms = _synced_ms(torch, lambda: noise.subset(n, k, "cuda"))
        draw_ms.append(ms)
        if idx.numel() != k or int(idx.min()) < 0 or int(idx.max()) >= n:
            fail("phase 4f: the support draw left range(n)")
        del idx
    del x
    log(f"phase 4f: at the full buffer ({n} coordinates, k = {k}): top-k selection "
        f"{topk_ms} ms, support draw {draw_ms} ms")
    return counts_all, peaks


# ---------------------------------------------------------------------------
# phase 4g: fault tolerance on the train path (the guard, faults, rollback)
# ---------------------------------------------------------------------------


GUARD_STEPS, FAULT_STEPS, EF_GUARD_STEPS = 4, 6, 3
FAULT_SPEC = "nan_grad@1;wire_corrupt@3-4"
EF_GUARD_SPEC = "nan_grad@1"
EXCHANGE_KERNELS = ("quantize_blocks", "dequant_reduce_requantize_blocks", "dequantize_blocks")


def _host_state(model, opt_state, ex_state) -> dict:
    """Every leaf of the run's state (the checkpoint's trees: params,
    optimizer and exchange state, their counters included) copied whole to
    the host, by path."""
    from repro_torch.checkpoint import checkpointing
    from repro_torch.launch.train import state_trees

    leaves = checkpointing._flatten_with_paths(state_trees(model, opt_state, ex_state))
    return {k: (v.detach().to("cpu", copy=True) if hasattr(v, "detach") else v)
            for k, v in leaves.items()}


def _same_state(torch, got: dict, want: dict) -> list:
    """The paths whose leaves differ (bitwise, whole tensors)."""
    if sorted(got) != sorted(want):
        return ["<paths>"]
    return [k for k in want if not (
        torch.equal(got[k], want[k]) and got[k].dtype == want[k].dtype
        if torch.is_tensor(want[k]) else got[k] == want[k])]


def _guarded_run(torch, tag, args, on_step=None):
    """``run(args)`` with the launch counts and the peak reset just before
    and read just after: (run()'s output, counts, peak bytes)."""
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import run

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    out = run(args, log=lambda m: log(f"  {tag}: {m}"), on_step=on_step)
    counts = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not out["step_s"]:
        fail(f"phase 4g {tag}: no step ran")
    return out, counts, peak


def guard_path(torch, batch: int, seq: int, fixed: dict, ef_peak: int) -> dict:
    """Phase 4g: the fault-tolerance layer on tinyllama-1.1b at full width
    (bf16 layers, K = 1, qgenx ``de``, int8 two_phase, host noise), through
    ``run()``:

    (a) 4 steps with ``--guard`` and no fault, and the same 4 steps
        unguarded from the same start: the params after every step
        bitwise equal (both runs under ``torch.use_deterministic_algorithms``,
        so the embedding's backward sums in one order); both runs' step
        times and peaks printed;
    (b) ``--guard --rollback-after 2 --fault-spec "nan_grad@1;wire_corrupt@3-4"``
        for 6 steps: step 1 rejected with ``nonfinite`` 1 after kernels 1-3
        ran on the NaN-poisoned buffer, the whole state after it bitwise
        equal to the state before it; steps 3 and 4 rejected and the
        watchdog's rollback after step 4 restoring the step-3 snapshot
        bitwise; step 5 committing a finite loss; the summary
        ``nonfinite_steps=3 rejected=3 rollbacks=1``; kernels 1-3 twice a
        step; the snapshot's bytes and seconds per good step, the
        rollback's seconds and the peak printed;
    (c) 3 guarded ``de`` steps under ``--compressor ef21-topk
        --ef-topk-frac 0.25`` with ``nan_grad@1``: the ``[1, n]`` error
        memory after step 1 bitwise equal to its value before it, and the
        peak printed beside phase 4f's (``ef_peak``).

    Returns the launch counts of (a) and (b)."""
    from repro_torch.core import faults
    from repro_torch.kernels import cuda

    base = dict(arch="tinyllama-1.1b", dtype="bfloat16", batch=batch, seq=seq, device="cuda",
                optimizer="qgenx", method="de", compression="int8",
                compress_mode="two_phase")
    total = {k: 0 for k in cuda.KERNELS}

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # (a) the guard adds no arithmetic
    plain_params = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain, counts, plain_peak = _guarded_run(
            torch, "4g(a) unguarded", _train_args(steps=GUARD_STEPS, **base),
            on_step=lambda t, model, o, e, m: plain_params.append(
                [p.detach().to("cpu", copy=True) for p in model.param_leaves()]))
        add(counts)
        diverged, costs = [], {}

        def same_params(t, model, o, e, m):
            if not all(torch.equal(p.detach().cpu(), q)
                       for p, q in zip(model.param_leaves(), plain_params[t])):
                diverged.append(t)
            if t == GUARD_STEPS - 1:  # the guard's two passes alone, on this state
                params = model.param_leaves()
                for _ in range(2):  # the second of each kept
                    ok, costs["finite_ms"] = _synced_ms(torch, lambda: bool(
                        faults.tree_all_finite(m["loss"], params, o, e)))
                    copy, costs["copy_ms"] = _synced_ms(
                        torch, lambda: [p.detach().clone() for p in params])
                    del copy
                if not ok:
                    fail("phase 4g(a): tree_all_finite rejects a finite state")

        guarded, counts, guarded_peak = _guarded_run(
            torch, "4g(a) guarded", _train_args(steps=GUARD_STEPS, guard=True, **base),
            on_step=same_params)
        add(counts)
    finally:
        torch.use_deterministic_algorithms(False)
    del plain_params
    if diverged or guarded["loss"] != plain["loss"]:
        fail(f"phase 4g(a): the guarded params differ from the unguarded ones after steps "
             f"{diverged} (losses {guarded['loss']} vs {plain['loss']})")
    if any(guarded["rejected"]) or guarded["guard"] != {"nonfinite_steps": 0, "rejected": 0,
                                                         "rollbacks": 0}:
        fail(f"phase 4g(a): a fault-free guarded run rejected steps: {guarded['guard']}")
    log(f"  phase 4g(a): {GUARD_STEPS} guarded steps bitwise equal to the unguarded ones; "
        f"step_s guarded {guarded['step_s']} vs unguarded {plain['step_s']}; peak "
        f"{guarded_peak} vs {plain_peak} bytes ({(guarded_peak - plain_peak) / 1e9:+.3f} GB); "
        f"snapshots {[(s['bytes'], round(s['seconds'], 3)) for s in guarded['snapshots']]}; "
        f"alone on the step-{GUARD_STEPS - 1} state: the finiteness pass "
        f"{costs['finite_ms']:.2f} ms, the params copy {costs['copy_ms']:.2f} ms")

    # (b) rejection and rollback
    held, bad = {}, []

    def check(t, model, o, e, m):
        torch.cuda.synchronize()  # a kernel fault on the poisoned buffer surfaces here
        if t in (1, 3, 4):
            diff = _same_state(torch, _host_state(model, o, e), held["state"])
            if diff or not m["rejected"] or not m["nonfinite"]:
                bad.append((t, m["rejected"], m["nonfinite"], diff[:4]))
        elif m["rejected"] or m["nonfinite"]:
            bad.append((t, m["rejected"], m["nonfinite"]))
        elif t in (0, 2):  # the state steps 1, 3 and 4 must carry
            held["state"] = None
            gc.collect()
            held["state"] = _host_state(model, o, e)

    out, counts, peak = _guarded_run(
        torch, "4g(b)", _train_args(steps=FAULT_STEPS, guard=True, rollback_after=2,
                                    fault_spec=FAULT_SPEC, **base), on_step=check)
    add(counts)
    del held["state"]
    if bad:
        fail(f"phase 4g(b): steps whose verdict or carried state is wrong: {bad}")
    want_counts = {k: (2 * FAULT_STEPS if k in EXCHANGE_KERNELS else 0) for k in cuda.KERNELS}
    if counts != want_counts:
        fail(f"phase 4g(b) launches {counts} != {want_counts}")
    if out["guard"] != {"nonfinite_steps": 3, "rejected": 3, "rollbacks": 1} or [
            (r["step"], r["to_step"]) for r in out["rollbacks"]] != [(4, 3)]:
        fail(f"phase 4g(b): guard {out['guard']}, rollbacks {out['rollbacks']}")
    if out["rejected"] != [0.0, 1.0, 0.0, 1.0, 1.0, 0.0] or not math.isfinite(out["loss"][5]):
        fail(f"phase 4g(b): rejected {out['rejected']}, losses {out['loss']}")
    snaps = out["snapshots"]
    log(f"  phase 4g(b): rejected {out['rejected']} nonfinite {out['nonfinite']} "
        f"loss {out['loss']} step_s {out['step_s']} wire_bytes {out['wire_bytes']} "
        f"coded_bits_est {out['coded_bits_est']} peak {peak} bytes launches {counts}")
    log(f"phase 4g(b): nonfinite_steps=3 rejected=3 rollbacks=1; the state after each "
        f"rejected step and after the rollback bitwise equal to the last good one; "
        f"snapshot {snaps[0]['bytes']} bytes, "
        f"{[round(s['seconds'], 3) for s in snaps]} s at the good steps "
        f"{[s['step'] - 1 for s in snaps]}; rollback {out['rollbacks'][0]['seconds']:.3f} s; "
        f"peak {peak} bytes (4a int8: {fixed['peak_bytes']})")

    # (c) the error-feedback memory under the guard
    err_before = {}

    def check_error(t, model, o, e, m):
        if t == 0:
            err_before["error"] = e.error.detach().to("cpu", copy=True)
        elif t == 1:
            same = bool(m["rejected"]) and torch.equal(e.error.detach().cpu(),
                                                       err_before["error"])
            err_before["ok"] = same
            del err_before["error"]

    ef, counts, ef_guard_peak = _guarded_run(
        torch, "4g(c)", _train_args(arch="tinyllama-1.1b", dtype="bfloat16", batch=batch,
                                    seq=seq, device="cuda", optimizer="qgenx", method="de",
                                    compressor="ef21-topk", ef_topk_frac=SPARSE_FRAC,
                                    steps=EF_GUARD_STEPS, guard=True,
                                    fault_spec=EF_GUARD_SPEC), on_step=check_error)
    err = ef.pop("ex_state").error
    if not err_before.get("ok") or ef["rejected"] != [0.0, 1.0, 0.0] or any(counts.values()):
        fail(f"phase 4g(c): error memory restored {err_before.get('ok')}, rejected "
             f"{ef['rejected']}, launches {counts}")
    log(f"phase 4g(c): ef21-topk de, nan_grad@1: the {tuple(err.shape)} error memory "
        f"({err.numel() * 4} bytes) after the rejected step bitwise equal to its value "
        f"before it; step_s {ef['step_s']}; peak {ef_guard_peak} bytes (phase 4f unguarded: "
        f"{ef_peak}, {(ef_guard_peak - ef_peak) / 1e9:+.3f} GB)")
    del err, ef
    return {"counts": total, "finite_ms": costs["finite_ms"], "copy_ms": costs["copy_ms"],
            "guarded_step_s": guarded["step_s"],
            "plain_step_s": plain["step_s"], "guarded_peak": guarded_peak,
            "plain_peak": plain_peak, "fault_peak": peak, "ef_peak": ef_guard_peak}


def _offsets(tree) -> list:
    out, pos = [], 0
    for g in tree:
        out.append(pos)
        pos += g.numel()
    return out


# ---------------------------------------------------------------------------
# phase 4e: the toy-VI testbed (Q-GenX loop, QSGDA) on the card
# ---------------------------------------------------------------------------


TOY_K, TOY_T = 4, 2048
TOY_SPARSE = ("ef21-topk", "ef-randk", "randk")  # frac 0.25 each: k = 16 of 64
TOY_GAP_RTOL = 1e-2  # card vs CPU port, the same draws (see toy_vi_path)


def toy_arms():
    """(name, problem, sigma, config or None for QSGDA) of phase 4e."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.extragradient import QGenXConfig
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.core.vi import bilinear_saddle

    uq8 = QuantConfig(num_levels=15, bits=8, bucket_size=64, q_norm=math.inf)
    uq4 = QuantConfig(num_levels=5, bits=4, bucket_size=64, q_norm=math.inf)
    fig4, arms = bilinear_saddle(d=16, seed=6), bilinear_saddle(d=32, seed=4)
    de = lambda **kw: QGenXConfig(variant="de", num_workers=TOY_K, **kw)  # noqa: E731
    return [("fig4-qgenx-fp32", fig4, 0.1, de()), ("fig4-qgenx-uq8", fig4, 0.1, de(quant=uq8)),
            ("fig4-qsgda", fig4, 0.1, None),
            ("d32-fp32", arms, 0.5, de()), ("d32-uq8", arms, 0.5, de(quant=uq8)),
            ("d32-uq4", arms, 0.5, de(quant=uq4)),
            ("d32-uq8-qada", arms, 0.5, de(quant=uq8, level_update_every=32))] + [
            (f"d32-{c}", arms, 0.5, de(exchange=ExchangeConfig(compressor=c)))
            for c in TOY_SPARSE]


def _toy_run(torch, vi, sigma, cfg, device, seed):
    """One arm on ``device``: (restricted gap of the ergodic iterate, state
    or None, seconds)."""
    from repro_torch.core.extragradient import qgenx_run, qsgda_run
    from repro_torch.core.vi import absolute_noise_oracle, restricted_gap

    oracle = absolute_noise_oracle(vi, sigma, device)
    x0 = torch.from_numpy(vi.z_star.astype("float32")) + 1.0
    noise = _NumpyNoise(seed)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cfg is None:
        _, x_avg = qsgda_run(x0, oracle, noise, TOY_T, num_workers=TOY_K, lr=0.05, device=device)
        st = None
    else:
        st = qgenx_run(x0, oracle, cfg, noise, TOY_T, device)
        x_avg = st.x_avg
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return restricted_gap(vi, x_avg), st, dt


def toy_vi_path(torch) -> tuple:
    """Phase 4e: the paper's toy-VI testbed on the card, K = 4 simulated
    workers, T = 2048 steps per arm (sizes of ``tests/test_extragradient.py``):
    Fig. 4's bilinear_saddle(d=16, seed=6) with absolute noise sigma = 0.1,
    Q-GenX ``de`` fp32 and uq8 against QSGDA at lr 0.05; then
    bilinear_saddle(d=32, seed=4) (64 operator coordinates), sigma = 0.5,
    ``de`` fp32, uq8 (s = 15, bucket 64, q = inf), uq4 (s = 5) and uq8 with
    QAda every 32 steps.  Every arm draws from a numpy stream (the same
    draws on any device) and runs again on the CPU port.  Fails unless
    Q-GenX's gap is below QSGDA's, the QAda arm's levels moved from
    uniform, kernel 5 launched 2T times in each quantized arm (one launch
    per exchange for the K stacked duals) and never elsewhere, and each
    gap equals the CPU run's within rtol ``TOY_GAP_RTOL`` (the operator's
    f32 products sum in another order on the card, which may move a
    stochastic rounding over 2048 steps).  The uq8 d = 32 arm's first
    kernel-5 call is kept, held bit-equal to the plain version and timed
    at that [4 x 64] shape (device time from ``torch.profiler``, wrapper
    time).  Returns (kernel 5 launches, the toy-shape kernel row)."""
    from repro_torch.core import exchange_plan
    from repro_torch.core.quantization import uniform_levels
    from repro_torch.kernels import cuda, ref

    wrapper = exchange_plan.quantize_dequantize_segments
    first = {}

    def recorder(x2d, noise, tables, seg_ids, **kw):
        out = wrapper(x2d, noise, tables, seg_ids, **kw)
        if arm not in first:
            first[arm] = ([t.clone() if t is not None else None
                           for t in (x2d, noise, tables, seg_ids)], kw, out.clone())
        return out

    gaps, launches = {}, 0
    exchange_plan.quantize_dequantize_segments = recorder
    try:
        for i, (arm, vi, sigma, cfg) in enumerate(toy_arms()):
            cuda.reset_launch_counts()
            gap, st, dt = _toy_run(torch, vi, sigma, cfg, "cuda", 100 + i)
            counts = cuda.launch_counts()
            n = counts["quantize_dequantize_segments"]
            quantized = cfg is not None and cfg.quant is not None
            if n != (2 * TOY_T if quantized else 0) or any(
                    v for k, v in counts.items() if k != "quantize_dequantize_segments"):
                fail(f"phase 4e arm {arm}: launches {counts}, expected kernel 5 "
                     f"{2 * TOY_T if quantized else 0} times and nothing else")
            launches += n
            cpu_gap, _, cpu_dt = _toy_run(torch, vi, sigma, cfg, "cpu", 100 + i)
            if not (math.isfinite(gap) and abs(gap - cpu_gap) <= TOY_GAP_RTOL * abs(cpu_gap)):
                fail(f"phase 4e arm {arm}: gap {gap!r} on the card vs {cpu_gap!r} on the CPU")
            bits = float(st.bits_sent) if st is not None else float("nan")
            gaps[arm] = gap
            extra = ""
            if cfg is not None and cfg.level_update_every:
                lv = st.levels
                if torch.allclose(lv, uniform_levels(lv.shape[0] - 2, lv.device), atol=1e-4):
                    fail(f"phase 4e arm {arm}: levels {lv.tolist()} did not move from uniform")
                extra = f" levels={[round(v, 5) for v in lv.tolist()]}"
            log(f"  toy {arm}: restricted_gap={gap!r} (cpu {cpu_gap!r}, rel diff "
                f"{abs(gap - cpu_gap) / abs(cpu_gap):.2e}) bits_sent={bits!r} "
                f"ms_per_step={dt / TOY_T * 1e3:.4f} (cpu {cpu_dt / TOY_T * 1e3:.4f}) "
                f"kernel5_launches={n}{extra}")
    finally:
        exchange_plan.quantize_dequantize_segments = wrapper
    if not gaps["fig4-qgenx-fp32"] < gaps["fig4-qsgda"]:
        fail(f"phase 4e: Q-GenX gap {gaps['fig4-qgenx-fp32']} is not below QSGDA's "
             f"{gaps['fig4-qsgda']}")
    log(f"phase 4e: Fig. 4 gaps Q-GenX fp32 {gaps['fig4-qgenx-fp32']!r}, uq8 "
        f"{gaps['fig4-qgenx-uq8']!r}, QSGDA {gaps['fig4-qsgda']!r}")
    # the path's own kernel-5 call at the toy shape, against the plain version, timed
    (x, r, tables, seg), kw, got = first["d32-uq8"]
    if tuple(x.shape) != (TOY_K, 64) or kw["num_symbols"] != (17,):
        fail(f"phase 4e: kernel 5 called on {tuple(x.shape)} with {kw}")
    want = ref.quantize_dequantize_segments_plain(x, r, tables, seg, **kw)
    tag = f"toy VI uq8 [{TOY_K} x 64] T=1 ns=(17,)"
    err = _check_segment(torch, f"{tag} (the path's output)", got, want, True)
    wrapper_ms, again = _time_ms(torch, lambda: wrapper(x, r, tables, seg, **kw), 200)
    _check_segment(torch, f"{tag} (timed)", again, want, True)
    ms = device_ms(torch, lambda: wrapper(x, r, tables, seg, **kw), "segment_qdq_kernel", 200)
    plain, _ = _time_ms(torch, lambda: ref.quantize_dequantize_segments_plain(
        x, r, tables, seg, **kw), 50)
    n = x.numel()
    row = kernel_row("quantize_dequantize_segments/toy-vi-uq8", launches, ms, plain, err,
                     12 * n + 4 * x.shape[0] + 4 * tables.numel(), n * (10 + 17),
                     f"{tag}, the toy-VI path's shape; device time")
    row["wrapper_ms"] = wrapper_ms
    log(f"    wrapper (host and device, back to back): {wrapper_ms:.4f} ms a call")
    return launches, row


GAN_TABLES = {"uq8": (17,), "uq4": (7,), "layerwise": (7, 17)}  # kernel 5's num_symbols
GAN_PRNG_ARM = "uq8-prng"


def gan_path(torch, int_ops: float) -> tuple:
    """The WGAN-GP testbed at the reference's width: every arm
    through the CLI's ``run``, then the uq8 arm with the device PRNG
    (``GANConfig(exchange=ExchangeConfig(..., use_device_prng=True))``
    through ``wgan.train``), the launch counts reset just before each arm
    and read just after.

    While it runs, the kernel-5 wrapper that ``fused_compress`` calls is
    wrapped to keep a copy of its first call's inputs and output in each
    arm (during step 0, which the median step time leaves out).  After the
    arms, each copy's output, the path's own, is held bit-equal to the
    plain version on the same inputs, and the wrapper is timed at that
    shape ([K x 19, 512]: 3 workers' buffers in one launch).  Returns
    ({arm: (result, kernel 5 launches)}, the GAN-shape kernel rows)."""
    from repro_torch.core import exchange_plan
    from repro_torch.core.tree import tree_leaves
    from repro_torch.gan import wgan
    from repro_torch.kernels import cuda, ref
    from repro_torch.launch import train_gan

    wrapper = exchange_plan.quantize_dequantize_segments
    first = {}

    def recorder(x2d, noise, tables, seg_ids, **kw):
        out = wrapper(x2d, noise, tables, seg_ids, **kw)
        if arm not in first:
            first[arm] = ([t.clone() if t is not None else None
                           for t in (x2d, noise, tables, seg_ids)], kw, out.clone())
        return out

    out = {}
    workers = train_gan.parser().parse_args([]).workers
    exchange_plan.quantize_dequantize_segments = recorder
    try:
        for arm in train_gan.ARMS + (GAN_PRNG_ARM,):
            cuda.reset_launch_counts()
            if arm == GAN_PRNG_ARM:
                cfg = wgan.GANConfig(num_workers=workers, exchange=dataclasses.replace(
                    train_gan.arm_exchange("uq8"), use_device_prng=True))
                res = wgan.train(cfg, steps=GAN_STEPS, device="cuda")
            else:
                args = train_gan.parser().parse_args(["--steps", str(GAN_STEPS), "--arms", arm])
                res = train_gan.run(args, log=lambda m: log(f"  {m}"))[arm]
            counts = cuda.launch_counts()
            kernel = ("quantize_dequantize_segments/prng" if arm == GAN_PRNG_ARM
                      else "quantize_dequantize_segments")
            other = ("quantize_dequantize_segments" if arm == GAN_PRNG_ARM
                     else "quantize_dequantize_segments/prng")
            n = counts[kernel]
            # one launch per exchange; fp32 and randk25 run no kernel
            want = 0 if arm in ("fp32", "randk25") else 2 * GAN_STEPS
            if n != want or counts[other]:
                fail(f"GAN arm {arm}: {kernel} launched {n} times (expected {want}), "
                     f"{other} {counts[other]}")
            if not math.isfinite(res["energy_distance"]):
                fail(f"GAN arm {arm}: energy distance {res['energy_distance']}")
            if arm == "randk25":
                want_bytes = 2 * sum(8 * max(1, round(0.25 * p.numel()))
                                     for p in tree_leaves(res["params"]))
                if res["bytes_per_step_per_worker"] != want_bytes:
                    fail(f"GAN arm randk25: {res['bytes_per_step_per_worker']} bytes a step, "
                         f"expected 2 x sum of 8 max(1, round(size / 4)) = {want_bytes}")
            out[arm] = (res, n)
            log(f"  gan {arm}: energy_distance={res['energy_distance']!r} "
                f"median_step_ms={res['median_step_ms']!r} "
                f"bytes_per_step_per_worker={res['bytes_per_step_per_worker']:.0f} "
                f"{kernel}_launches={n}")
    finally:
        exchange_plan.quantize_dequantize_segments = wrapper
    ed8, ed32 = out["uq8"][0]["energy_distance"], out["fp32"][0]["energy_distance"]
    if not ed8 < 2 * ed32 + 0.5:
        fail(f"GAN uq8 energy distance {ed8} breaks the bound 2 * fp32 ({ed32}) + 0.5")
    log(f"phase 4b: energy distance uq8 {ed8!r} (host noise) vs "
        f"{out[GAN_PRNG_ARM][0]['energy_distance']!r} (device PRNG, one seed: not held to "
        "the bound)")

    # the path's own kernel-5 calls against the plain version, then timed
    rows = []
    for arm, ns in list(GAN_TABLES.items()) + [(GAN_PRNG_ARM, GAN_TABLES["uq8"])]:
        if arm not in first:
            fail(f"GAN arm {arm}: no kernel-5 call was recorded")
        (x, r, tables, seg), kw, got = first[arm]
        prng = arm == GAN_PRNG_ARM
        if (tuple(x.shape) != (workers * 19, 512) or kw["num_symbols"] != ns
                or not kw["q_is_inf"] or not kw["stochastic"]
                or (r is None) != prng or (kw.get("seed") is None) == prng):
            fail(f"GAN arm {arm}: kernel 5 called on {tuple(x.shape)} with {kw}, expected "
                 f"[{workers * 19}, 512] with num_symbols {ns}, q = inf, stochastic, "
                 f"{'a seed' if prng else 'a noise buffer'}")
        tag = f"GAN {arm} [{x.shape[0]} x 512] T={len(ns)} ns={ns}"
        want = ref.quantize_dequantize_segments_plain(x, r, tables, seg, **kw)
        err = _check_segment(torch, f"{tag} (the path's output)", got, want, True)
        wrapper_ms, again = _time_ms(torch, lambda: wrapper(x, r, tables, seg, **kw), 200)
        _check_segment(torch, f"{tag} (timed)", again, want, True)
        ms = device_ms(torch, lambda: wrapper(x, r, tables, seg, **kw), "segment_qdq_kernel",
                       200)
        plain, _ = _time_ms(torch, lambda: ref.quantize_dequantize_segments_plain(
            x, r, tables, seg, **kw), 50)
        n = x.numel()
        name = ("quantize_dequantize_segments/prng/gan-uq8" if prng
                else f"quantize_dequantize_segments/gan-{arm}")
        row = kernel_row(name, out[arm][1], ms, plain, err,
                         (8 if prng else 12) * n + 4 * x.shape[0] + 4 * tables.numel(),
                         n * (10 + max(ns)), f"{tag}, the GAN path's shape; device time",
                         int_ops=n * int_ops if prng else 0)
        row["wrapper_ms"] = wrapper_ms
        log(f"    wrapper (host and device, back to back): {wrapper_ms:.4f} ms a call")
        rows.append(row)
    return out, rows


class _NumpyNoise:
    """The same uniform draws and seeds on any device, from one numpy
    stream."""

    def __init__(self, seed):
        import numpy as np

        self.rng = np.random.RandomState(seed)

    def seed(self):
        import numpy as np

        return int(self.rng.randint(0, 2**62, dtype=np.int64))

    def uniform(self, shape, device):
        import torch

        a = self.rng.random_sample(tuple(shape)).astype("float32")
        return torch.from_numpy(a).to(device)

    def rademacher(self, shape, device):
        import torch

        a = (2 * self.rng.randint(0, 2, size=tuple(shape)) - 1).astype("float32")
        return torch.from_numpy(a).to(device)

    def subset(self, n, k, device):
        import torch

        return torch.from_numpy(self.rng.permutation(n)[:k].astype("int32")).to(device)


# ---------------------------------------------------------------------------
# phase 4h: the serving path (paged quantized KV-cache, continuous batching)
# ---------------------------------------------------------------------------

# 4h's requests, cut from 48 to 32 when phase 4j was added and to 16 with
# phase 4k: the phase is host-bound (110.7-153.9 s at 48 and 88.8-114.7 s at
# 32 on an H100 80GB HBM3), and fewer requests keep the script inside its
# time with every path and check (the half-pages, guard and exchange runs
# already served 16)
SERVE_REQUESTS = 16
SERVE_ARGV = ("--batch", "16", "--requests", str(SERVE_REQUESTS), "--prompt-len", "512",
              "--gen", "128",
              "--page-size", "16")
SERVE_FAULTS = "nan_logits@5:slot=2;page_corrupt@9:slot=7;slot_drop@12:slot=11"
# a full forward and the paged decode sum in different orders: where their
# argmax differs, the full forward's top two logits must lie within this
SERVE_GAP_TOL = 1e-3
CACHE_KERNELS = ("quantize_blocks", "dequantize_blocks")


def _serve_args(*extra, reduced=False, device="cuda", base=SERVE_ARGV):
    from repro_torch.launch import serve

    argv = list(base) + list(extra) + ["--device", device]
    return serve.parser().parse_args(argv + (["--reduced"] if reduced else []))


def _serve_run(torch, args, tag, counted=True, phase="4h", config=None):
    """One ``repro_torch.launch.serve.run`` (``config`` replaces the
    model config of ``--arch``): the launch counts reset just before and
    read just after; returns its dict with ``counts``, ``peak``, the
    per-wave and per-prefill seconds and ``tok_s``."""
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve

    lines = []
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    out = serve.run(args, say=lines.append, config=config)
    counts = cuda.launch_counts()
    out["peak"] = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    eng = out["engine"]
    out["counts"] = counts
    out["tokens"] = sum(len(v) for v in out["out"].values())
    out["tok_s"] = out["tokens"] / out["wall_s"]
    waves, pre = sorted(eng.timing["wave_s"]), sorted(eng.timing["prefill_s"])
    out["wave_ms"] = 1e3 * waves[len(waves) // 2]
    out["prefill_ms"] = 1e3 * pre[len(pre) // 2]
    for line in lines:
        if not line.startswith(("[serve]   step", "[serve] result")):
            log(f"    {line}")
    st = eng.sched.stats
    log(f"  phase {phase} {tag}: {out['tokens']} tokens, {eng.sched.decode_steps} waves, "
        f"{len(pre)} prefills in {out['wall_s']:.3f} s: {out['tok_s']:.1f} tok/s; prefill "
        f"{out['prefill_ms']:.2f} ms, decode {out['wave_ms']:.2f} ms a wave (median; "
        f"{1e3 * waves[0]:.2f}-{1e3 * waves[-1]:.2f}); peak {out['peak']} B; cache "
        f"{eng.cache_bytes} B ({eng.fp32_cache_bytes / eng.cache_bytes:.2f}x below fp32); "
        f"max_concurrent {st['max_concurrent']}, mid_decode_admits "
        f"{st['mid_decode_admits']}; launches {[(k, counts[k]) for k in CACHE_KERNELS]}")
    if counted:
        want1 = 2 * eng.pc.num_layers * (eng.sched.decode_steps + len(pre))
        want3 = 2 * eng.pc.num_layers * eng.sched.decode_steps
        if args.kv_bits == "32":
            want1 = want3 = 0
        got = (counts["quantize_blocks"], counts["dequantize_blocks"])
        if got != (want1, want3) or any(counts[k] for k in counts if k not in CACHE_KERNELS):
            fail(f"phase {phase} {tag}: launches {counts}, want kernel 1 {want1} (2 x "
                 f"{eng.pc.num_layers} a wave and a prefill) and kernel 3 {want3}")
    return out


def _check_fp32_tokens(torch, run, phase="4h") -> int:
    """Every fp32 paged request's tokens against a full forward's argmax
    over its prompt + generated tokens; a differing token must be a near
    tie (top two within SERVE_GAP_TOL).  Returns the near ties seen."""
    eng, ties = run["engine"], 0
    reqs = {s.req.rid: s.req for s in eng.sched.finished}
    with torch.no_grad():
        for rid, toks in run["out"].items():
            prompt = list(reqs[rid].prompt)
            seq = torch.tensor([prompt + toks[:-1]], device=eng.device)
            logits = eng.model(seq)[0, len(prompt) - 1:]
            pred = torch.argmax(logits, dim=-1).tolist()
            for t, (a, b) in enumerate(zip(pred, toks)):
                if a != b:
                    top = torch.topk(logits[t], 2).values
                    gap = float(top[0] - top[1])
                    if gap >= SERVE_GAP_TOL:
                        fail(f"phase {phase} fp32: request {rid} token {t} is {b}, the full "
                             f"forward's argmax {a} (gap {gap})")
                    ties += 1
    return ties


def _request_pages(eng, rid):
    """The pages a retired request held, in its table's order."""
    return next(s.pages for s in eng.sched.finished if s.req.rid == rid)


def _check_alone(torch, run) -> None:
    """(b): the request that retires last in ``run`` (its pages are reused by
    no one after it), served alone by a fresh engine on the same model: its
    tokens and its pages' payloads and norms at every written position, all
    layers, bit-equal to the packed run's."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request

    eng = run["engine"]
    last = next(rid for kind, rid, _, _ in reversed(run["events"]) if kind == "retire")
    req = next(s.req for s in eng.sched.finished if s.req.rid == last)
    alone = ServeEngine(eng.cfg, eng.model, policy="int8", page_size=eng.pc.page_size,
                        n_slots=eng.n_slots, max_len=eng.pc.max_len, seed=0)
    out = alone.run([Request(req.rid, list(req.prompt), req.max_new)])
    if out[last] != run["out"][last]:
        fail(f"phase 4h: request {last} alone {out[last][:8]}... != packed")
    n_pos = len(req.prompt) + req.max_new - 1
    pa, pb = _request_pages(alone, last), _request_pages(eng, last)
    for name in eng.cache:
        a = alone.cache[name][:, pa].flatten(1, 2)[:, :n_pos]
        b = eng.cache[name][:, pb].flatten(1, 2)[:, :n_pos]
        if not torch.equal(a, b):
            fail(f"phase 4h: request {last}'s {name} differs alone and packed")
    log(f"  phase 4h: request {last} ({len(out[last])} tokens, {len(pa)} pages of "
        f"{eng.pc.page_size}) bit-equal alone and packed, tokens and pages")


def _exchange_run(torch, run, counted) -> dict:
    """(e): the engine with an int8 two_phase logit exchange at world size 1,
    on ``run``'s model and its first 16 requests."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels import cuda
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request

    base = run["engine"]
    q = QuantConfig(num_levels=15, bits=8, bucket_size=512)
    ex = ServeEngine(base.cfg, base.model, policy="int8", page_size=base.pc.page_size,
                     n_slots=base.n_slots, max_len=base.pc.max_len, seed=0,
                     exchange=ExchangeConfig(quant=q, mode="two_phase"))
    reqs = [Request(s.req.rid, list(s.req.prompt), min(32, s.req.max_new))
            for s in sorted(base.sched.finished, key=lambda s: s.req.rid)][:16]
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = ex.run(reqs)
    wall = time.perf_counter() - t0
    counts = cuda.launch_counts()
    waves, L = ex.sched.decode_steps, ex.pc.num_layers
    want = {"quantize_blocks": 2 * L * (waves + len(reqs)) + waves,
            "dequant_reduce_requantize_blocks": waves, "dequantize_blocks": 2 * L * waves + waves}
    if counted and {k: counts[k] for k in want} != want:
        fail(f"phase 4h exchange: launches {counts}, want {want}")
    if len(out) != len(reqs) or ex.wire_bytes != ex.wire_per_step * waves:
        fail(f"phase 4h exchange: {len(out)} answered, wire {ex.wire_bytes} != "
             f"{ex.wire_per_step} x {waves}")
    n_tok = sum(len(v) for v in out.values())
    wave_ms = 1e3 * sorted(ex.timing["wave_s"])[waves // 2]
    log(f"  phase 4h logit exchange (int8 two_phase, K = 1, {len(reqs)} requests): "
        f"{n_tok / wall:.1f} tok/s, decode {wave_ms:.2f} ms a wave (median), wire "
        f"{ex.wire_per_step:.0f} B a wave, coded_bits_est {ex.coded_bits:.0f}, launches "
        f"{ {k: counts[k] for k in want} }")
    return {"counts": counts, "tok_s": n_tok / wall, "wave_ms": wave_ms}


def serve_path(torch, reduced=False, device="cuda") -> dict:
    """Phase 4h: ``repro_torch.launch.serve`` at full width (tinyllama-1.1b,
    22 layers, f32 as the reference serves it, random weights from seed 0),
    ``--batch 16 --requests 16 --prompt-len 512 --gen 128 --page-size 16``
    (``SERVE_REQUESTS``, cut from 48; logged as a ``reduced:`` line);
    each run's model is freed before the next, so each peak is its own:

    (a) ``--kv-bits 8``, ``4`` and ``32``: every request answers; kernel 1
        launched 2 x 22 times a wave and a prefill, kernel 3 2 x 22 times a
        wave (none at fp32); the cache >= 2x below fp32 at int8, >= 4x at
        int4; the fp32 tokens equal a full forward's argmax over prompt +
        generated tokens except at near ties (``SERVE_GAP_TOL``);
    (b) after the int8 run, on its model, the request that retires last
        served alone (``_check_alone``);
    (e) then, on the same model, the engine with an int8 two_phase logit
        exchange at world size 1 over the first 16 requests, 32 tokens
        each: kernels 1-3 on the [16, 32000] logits once a wave,
        ``wire_bytes`` the analytic count, every request answers;
    (c) int8 with ``--num-pages`` at half the full provision, 16 requests
        of ``--gen 32``: admission waits (at most 8 at once), every request
        answers;
    (d) int8 ``--guard --fault-spec SERVE_FAULTS``, 16 requests of
        ``--gen 32`` (every slot busy at the faults' waves): the requests in
        slots 2 and 7 quarantined, the one in slot 11 dropped, every other
        request's tokens equal the first of (a)'s int8 tokens (the draws
        are keyed by request and position), every page free.

    Prints each run's tok/s, prefill and per-wave ms, peak and cache
    bytes.  Returns the runs' numbers and launch counts."""
    counted = device == "cuda"
    kw = dict(reduced=reduced, device=device)
    log(f"  reduced: phase 4h --requests 48 -> {SERVE_REQUESTS} (the phase's time, for phases "
        f"4j and 4k; every run and check kept)")
    runs = {}
    for bits in ("8", "4", "32"):
        run = _serve_run(torch, _serve_args("--kv-bits", bits, **kw), f"kv-bits {bits}", counted)
        eng = run["engine"]
        if len(run["out"]) != SERVE_REQUESTS or eng.allocator.n_free != eng.pc.num_pages:
            fail(f"phase 4h kv-bits {bits}: {len(run['out'])} of {SERVE_REQUESTS} requests "
                 "answered")
        ratio = eng.fp32_cache_bytes / eng.cache_bytes
        if ratio < {"8": 2.0, "4": 4.0, "32": 1.0}[bits]:
            fail(f"phase 4h kv-bits {bits}: cache only {ratio:.2f}x below fp32")
        if bits == "32":
            run["near_ties"] = _check_fp32_tokens(torch, run)
            log(f"  phase 4h fp32: every token equals the full forward's argmax but "
                f"{run['near_ties']} near ties (gap < {SERVE_GAP_TOL})")
        if bits == "8":
            _check_alone(torch, run)
            runs["exchange"] = _exchange_run(torch, run, counted)
            run["full_pages"] = eng.pc.num_pages
        run["engine"] = eng = None
        runs[bits] = run
    clean = runs["8"]["out"]
    # --gen 32: 34 pages a request, so half of the 544 a full provision
    # of 16 slots takes admits 8 at once
    half = _serve_run(torch, _serve_args("--kv-bits", "8", "--gen", "32", "--num-pages",
                                         str(16 * 34 // 2), "--requests", "16", **kw),
                      "int8, half the pages, 16 requests, gen 32", counted)
    st = half["engine"].sched.stats
    if len(half["out"]) != 16 or st["max_concurrent"] > 8:
        fail(f"phase 4h half pages: {len(half['out'])} answered, max_concurrent "
             f"{st['max_concurrent']}")
    half["engine"] = None
    guard = _serve_run(torch, _serve_args("--kv-bits", "8", "--guard", "--fault-spec",
                                          SERVE_FAULTS, "--requests", "16", "--gen", "32",
                                          **kw), "int8 --guard, faults, 16 requests, gen 32",
                       False)
    eng, events = guard["engine"], guard["events"]
    hit = {(kind, slot, step): rid for kind, rid, slot, step in events}
    q2, q7 = hit.get(("evict:quarantined", 2, 5)), hit.get(("evict:quarantined", 7, 9))
    d11 = hit.get(("evict:dropped", 11, 12))
    kinds = {rid: rr.kind for rid, rr in eng.results().items()}
    bad = {rid: k for rid, k in kinds.items() if k != "ok"}
    if None in (q2, q7, d11) or bad != {q2: "quarantined", q7: "quarantined", d11: "dropped"}:
        fail(f"phase 4h guard: typed results {bad}, events {[e for e in events if ':' in e[0]]}")
    # a request's draws are keyed by request and position: its first 32 - 2 (r % 3)
    # tokens are the clean run's
    diff = [rid for rid, toks in guard["out"].items() if toks != clean[rid][:len(toks)]]
    if diff or eng.allocator.n_free != eng.pc.num_pages:
        fail(f"phase 4h guard: requests {diff} differ from the clean run, "
             f"{eng.allocator.n_free} pages free")
    log(f"  phase 4h guard: requests {q2}, {q7} quarantined, {d11} dropped; the other "
        f"{len(guard['out'])} equal the clean run; guard_retries "
        f"{eng.sched.stats.get('guard_retries')}")
    guard["engine"] = None
    runs["half"], runs["guard"] = half, guard
    return runs


def serve_kernel_rows(torch, runs: dict, errs: dict) -> list:
    """Kernels 1 and 3 at the shapes the cache gives them on phase 4h's
    path: a decode wave's write ``[16, 256]``, a prefill's ``[512, 256]``
    and a wave's read ``[16 x 640, 256]`` (bucket 256 = 4 kv heads x 64),
    int8 and int4 (``kv_kernel_rows``).  ``launches`` is the kernel's count
    on phase 4h's run at that width (the write rows share it)."""
    launches = {bits: (runs[str(bits)]["counts"]["quantize_blocks"],
                       runs[str(bits)]["counts"]["dequantize_blocks"]) for bits in (8, 4)}
    return kv_kernel_rows(torch, 256, {"write": 16, "prefill": 512}, 16 * 640, launches, errs)


def kv_kernel_rows(torch, feat: int, writes: dict, read_rows: int, launches: dict,
                   errs: dict, suffix: str = "") -> list:
    """Kernel 1 on the cache writes ``writes`` (name -> token rows) and
    kernel 3 on a wave's read of ``read_rows`` token rows, ``feat`` features
    a token (the bucket), int8 and int4, each held to its plain version and
    timed: ``ms`` the kernel's device time a launch (``torch.profiler``) and
    ``plain_ms`` the plain version's time a call, each call after an L2
    flush (:func:`l2_flush`: on the decode path a layer's cache rows come
    from HBM, behind the other layers' work), and ``wrapper_ms`` the
    wrapper's time a call back to back.  ``launches`` maps bits to
    (kernel 1's, kernel 3's) count on the path at that shape; row names end
    in ``suffix``."""
    from repro_torch.core.quantization import uniform_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequantize import dequantize_blocks
    from repro_torch.kernels.quantize import quantize_blocks

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(feat)
    flush = l2_flush(torch)
    rows = []
    for bits in (8, 4):
        s = 15 if bits == 8 else 5
        lv = uniform_levels(s, dev)
        kw = dict(num_symbols=s + 2, q_is_inf=True, bits=bits)
        n_write, n_read = launches[bits]
        for what, n_rows in writes.items():
            x = torch.randn((n_rows, feat), generator=gen, device=dev)
            x[3] = 0.0
            r = torch.rand((n_rows, feat), generator=gen, device=dev)
            wrapper, got = _time_ms(torch, lambda: quantize_blocks(x, r, lv, **kw), 200)
            ms = device_ms(torch, lambda: quantize_blocks(x, r, lv, **kw), "quantize", 50,
                           flush)
            plain, want = _time_ms(torch, lambda: ref.quantize_blocks_plain(x, r, lv, **kw),
                                   20, flush)
            err = _deq_err(torch, f"kv {what} int{bits}{suffix}", got, want, lv, bits)
            n = n_rows * feat
            row = kernel_row(f"quantize_blocks/kv-{what}-int{bits}{suffix}", n_write,
                             ms, plain, max(err, errs["quantize_blocks"]),
                             8 * n + n * bits // 8 + 4 * n_rows, n * (10 + 2 * s),
                             f"{n_rows} x {feat}, int{bits}, the KV-cache {what}")
            row["wrapper_ms"] = wrapper
            log(f"    device {ms:.5f} ms vs wrapper {wrapper:.5f} ms a call")
            rows.append(row)
        pk, nk = quantize_blocks(torch.randn((read_rows, feat), generator=gen, device=dev),
                                 torch.rand((read_rows, feat), generator=gen, device=dev), lv,
                                 **kw)
        wrapper, got = _time_ms(torch, lambda: dequantize_blocks(pk, nk, lv, num_symbols=s + 2,
                                                                 bits=bits), 200)
        ms = device_ms(torch, lambda: dequantize_blocks(pk, nk, lv, num_symbols=s + 2,
                                                        bits=bits), "dequantize", 50, flush)
        plain, want = _time_ms(torch, lambda: ref.dequantize_blocks_plain(pk, nk, lv,
                                                                          bits=bits), 20, flush)
        err = _close(torch, f"kv read int{bits}{suffix}", got, want)
        n = read_rows * feat
        row = kernel_row(f"dequantize_blocks/kv-read-int{bits}{suffix}", n_read,
                         ms, plain, max(err, errs["dequantize_blocks"]),
                         n * bits // 8 + 4 * read_rows + 4 * n, 3 * n,
                         f"{read_rows} x {feat}, int{bits}, the KV-cache read of a wave")
        row["wrapper_ms"] = wrapper
        log(f"    device {ms:.5f} ms vs wrapper {wrapper:.5f} ms a call")
        rows.append(row)
    return rows


def card_vs_cpu(torch) -> None:
    """Reduced tinyllama, same weights and noise: 2 de steps on the card
    (CUDA kernels) vs on the CPU (plain versions), exact exchange, int8
    two_phase, and int8 two_phase with the device PRNG (the same seeds on
    both: the kernels' Philox against ``philox_uniform``)."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.quantization import QuantConfig

    int8 = ExchangeConfig(compressor="qgenx", mode="two_phase",
                          quant=QuantConfig(num_levels=15, bits=8, bucket_size=512))
    card_vs_cpu_runs(torch, ((ExchangeConfig(compressor="none"), 1e-4), (int8, 1e-3),
                             (dataclasses.replace(int8, use_device_prng=True), 1e-3)))


def _exchange_tag(ex_cfg) -> str:
    """A config's name in the log: compressor, mode, bits and layout."""
    tag = ex_cfg.compressor
    if ex_cfg.quant is not None:
        tag += f" int{ex_cfg.quant.bits} {ex_cfg.mode}"
    if ex_cfg.use_device_prng:
        tag += " device PRNG"
    if ex_cfg.overlap != "off":
        tag += f" {ex_cfg.num_buckets} buckets {ex_cfg.overlap}"
    if not ex_cfg.use_plan:
        tag += " per-call layout"
    if ex_cfg.allreduce_fallback:
        tag += " allreduce_fallback"
    return tag


def card_vs_cpu_runs(torch, configs) -> None:
    """For each ``(exchange config, rtol)``: reduced tinyllama, the same
    weights and noise, 2 qgenx de steps on the card (CUDA kernels) and on
    the CPU (plain versions), losses and params held within ``rtol``."""
    import copy

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.exchange import make_exchange
    from repro_torch.data.pipeline import make_pipeline, to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build
    from repro_torch.optim import qgenx as qgenx_opt
    from repro_torch.optim.optimizers import OptimizerConfig

    cfg = get_config("tinyllama-1.1b").reduced()
    base = build(cfg, seed=0, device="cpu")
    batch_np = next(make_pipeline(cfg.vocab_size, 4, 32, seed=0))
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=0.02, method="de")
    for ex_cfg, rtol in configs:
        results = []
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(base).to(dev)
            ex = make_exchange(ex_cfg)
            step = make_train_step(model, opt_cfg, ex)
            opt_state = qgenx_opt.init_qgenx_state(opt_cfg, model.param_leaves())
            ex_state = ex.init_state(dev, template=model.param_leaves(), num_workers=1)
            noise = _NumpyNoise(7)
            losses = []
            for _ in range(2):
                opt_state, ex_state, m = step(opt_state, ex_state,
                                              to_device(batch_np, dev), noise)
                losses.append(float(m["loss"]))
            results.append((np.array(losses), [p.detach().cpu() for p in model.param_leaves()]))
        (lc, pc), (lg, pg) = results
        what = _exchange_tag(ex_cfg)
        if not np.allclose(lg, lc, rtol=rtol, atol=0):
            fail(f"card vs cpu loss ({what}): {lg} vs {lc}")
        worst = max(float((a - b).norm() / b.norm()) for a, b in zip(pg, pc))
        if worst > rtol:
            fail(f"card vs cpu params ({what}): rel err {worst:.3e}")
        log(f"  card vs cpu ({what}): losses {lg} vs {lc}, worst param rel err {worst:.3e}")


# ---------------------------------------------------------------------------
# phase 4i: the other dense families (gemma-2b, qwen3-4b, gemma3-27b)
# ---------------------------------------------------------------------------

# (a)'s depth: qwen3-4b's 36 layers cut to 7, an exchange buffer of
# 1.1e9 coordinates (tinyllama-1.1b's size, at which the plain versions'
# full-buffer comparisons fit beside it); the step's peak is 30.4 GB on an
# H100 80GB HBM3 (73.0 GB at 8 layers while a reference cycle in
# ``core/tree.py`` held each step's garbage until the cyclic gc ran)
ARCH_TRAIN_LAYERS = 7
# (d)'s depth: gemma3-27b's 62 layers cut to two periods of its 5:1
# local:global pattern (~6.4e9 parameters, ~26 GB in f32)
GEMMA3_LAYERS = 12
ARCH_SERVE_ARGV = ("--batch", "16", "--requests", "16", "--prompt-len", "512", "--gen", "64",
                   "--page-size", "16")
# prompts past gemma3's 1024-token window, so the local layers mask keys
GEMMA3_SERVE_ARGV = ("--arch", "gemma3-27b", "--batch", "8", "--requests", "8",
                     "--prompt-len", "1536", "--gen", "64", "--page-size", "16")


def _bits_tally(module, name: str):
    """Wrap ``module.name`` (a kernel wrapper taking ``bits=``) so that its
    calls are counted by bits; returns (the tally, a function that undoes
    the wrap).  The wrapper's own launch count is untouched."""
    orig = getattr(module, name)
    tally = {4: 0, 8: 0}

    def counted(*a, **kw):
        tally[kw["bits"]] += 1
        return orig(*a, **kw)

    setattr(module, name, counted)
    return tally, lambda: setattr(module, name, orig)


def archs_train(torch, batch: int, seq: int, reduced=False, device="cuda") -> dict:
    """(a): qwen3-4b at full width (d_model 2560, 32 / 8 heads, head_dim 128,
    d_ff 9728, vocab 151936, qk-norm, rope 1e6) cut to ARCH_TRAIN_LAYERS
    layers (``train_cut``)."""
    return train_cut(torch, "qwen3-4b", ARCH_TRAIN_LAYERS, batch, seq, "4i(a)",
                     "a buffer of tinyllama's size; the peak below 70 GB; train phase only",
                     reduced=reduced, device=device)


def train_cut(torch, arch: str, layers: int, batch: int, seq: int, phase: str, why: str,
              reduced=False, device="cuda", max_peak: float = 70e9) -> dict:
    """``arch`` at full width cut to ``layers`` layers (``why`` logged on
    the ``reduced:`` line), bf16 layers, batch x seq on one card: 3 qgenx
    ``de`` steps with the int8 two_phase exchange and host noise through
    ``repro_torch.launch.train.run`` (a VLM's batches carry its stubbed
    prefix embeds).  Every loss finite, ``wire_bytes`` the analytic count
    of the gradient tree, kernels 1-3 once an exchange and no other
    kernel, the peak below ``max_peak`` bytes.  Returns the counts, step
    times, peak and the exchanged coordinates."""
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import make_exchange
    from repro_torch.core.exchange_plan import size_of
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import build_exchange_config, run

    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced() if reduced else full, num_layers=layers)
    log(f"  reduced: {arch} num_layers {full.num_layers} -> {cfg.num_layers} at full width "
        f"({why})")
    args = _train_args(arch=arch, dtype="float32" if reduced else "bfloat16",
                       batch=batch, seq=seq, device=device, optimizer="qgenx", method="de",
                       compression="int8", compress_mode="two_phase", steps=3)
    shapes = []

    def on_step(step, model, *_):
        if not shapes:
            shapes.extend(tuple(p.shape) for p in model.param_leaves())

    gc.collect()
    held = 0
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    cuda.reset_launch_counts()
    out = run(args, log=lambda m: log(f"    {m}"), config=cfg, on_step=on_step)
    counts = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    ex = make_exchange(build_exchange_config(args))
    sizes = [size_of(s) for s in shapes]
    calls = 2 * len(out["loss"])
    want_wire = 2 * ex.compressor.wire_bytes_tree(shapes, 1, ex.cfg)
    if not all(math.isfinite(v) for v in out["loss"]):
        fail(f"phase {phase}: non-finite loss {out['loss']}")
    if any(w != want_wire for w in out["wire_bytes"]):
        fail(f"phase {phase}: wire_bytes {out['wire_bytes']} != analytic {want_wire}")
    want = {k: calls if k in EXCHANGE_KERNELS else 0 for k in counts}
    if device == "cuda" and counts != want:
        fail(f"phase {phase}: launches {counts} != {want}")
    if peak - held > max_peak:
        fail(f"phase {phase}: the run's peak {peak - held} bytes above {max_peak:.0f} ({held} "
             f"held before it)")
    log(f"  phase {phase} {arch} de int8 two_phase ({sum(sizes)} coordinates): "
        f"loss={out['loss']} wire_bytes={out['wire_bytes'][0]:.0f} step_s={out['step_s']} "
        f"peak_bytes={peak} ({held} held before the run) "
        f"launches={ {k: v for k, v in counts.items() if v} }")
    return {"counts": counts, "step_s": out["step_s"], "peak": peak, "n_live": sum(sizes),
            "loss": out["loss"]}


def archs_serve(torch, reduced=False, device="cuda") -> dict:
    """(b)-(d): ``repro_torch.launch.serve`` at full width, f32, random
    weights from seed 0, each run's model freed before the next:

    (b) gemma-2b, all 18 layers, ``--kv-bits 8`` (ARCH_SERVE_ARGV);
    (c) qwen3-4b, all 36 layers, ``--kv-bits 4``, the same traffic;
    (d) gemma3-27b cut to GEMMA3_LAYERS layers (10 local, 2 global),
        ``--kv-bits mixed`` (GEMMA3_SERVE_ARGV: prompts past the window):
        the segment bits per layer ``layer_bit_policy``'s, kernel 1 launched
        2 x (local layers) times a wave and a prefill at bits 4 and 2 x
        (global layers) at bits 8, kernel 3 the same a wave; then 2
        requests at ``--kv-bits 32`` whose tokens equal the full forward's
        argmax but at near ties (banded prefill against windowed paged
        decode).

    Every request answers, every page is freed and the quantized caches
    are below fp32.  Returns the runs."""
    from repro_torch.configs import get_config
    from repro_torch.serve import kv_cache as KVC

    counted = device == "cuda"
    kw = dict(reduced=reduced, device=device)
    runs = {}
    for tag, arch, bits in (("b", "gemma-2b", "8"), ("c", "qwen3-4b", "4")):
        base = ARCH_SERVE_ARGV + ("--arch", arch)
        if reduced:
            base += ("--prompt-len", "96", "--gen", "8")
        run = _serve_run(torch, _serve_args("--kv-bits", bits, base=base, **kw),
                         f"({tag}) {arch} kv-bits {bits}", counted, phase="4i")
        eng = run["engine"]
        if len(run["out"]) != 16 or eng.allocator.n_free != eng.pc.num_pages:
            fail(f"phase 4i({tag}) {arch}: {len(run['out'])} of 16 answered")
        if eng.fp32_cache_bytes / eng.cache_bytes < {"8": 2.0, "4": 4.0}[bits]:
            fail(f"phase 4i({tag}) {arch}: cache {eng.cache_bytes} B vs fp32 "
                 f"{eng.fp32_cache_bytes} B")
        run["engine"] = eng = None  # each run's peak its own
        runs[tag] = run
    full = get_config("gemma3-27b")
    cfg = dataclasses.replace(full.reduced() if reduced else full, num_layers=GEMMA3_LAYERS)
    log(f"  reduced: gemma3-27b num_layers {full.num_layers} -> {cfg.num_layers} at full "
        f"width (two periods of 5 local : 1 global; ~{cfg.param_count() * 4 / 1e9:.1f} GB "
        f"in f32)")
    base = GEMMA3_SERVE_ARGV + (("--prompt-len", "96", "--gen", "8") if reduced else ())
    want_bits = KVC.layer_bit_policy(cfg, "mixed")
    n_local = want_bits.count(4)
    if want_bits != (4,) * 5 + (8,) + (4,) * 5 + (8,):
        fail(f"phase 4i(d): layer_bit_policy(mixed) = {want_bits}")
    writes, undo_w = _bits_tally(KVC, "quantize_blocks")
    reads, undo_r = _bits_tally(KVC, "dequantize_blocks")
    try:
        run = _serve_run(torch, _serve_args("--kv-bits", "mixed", base=base, **kw),
                         "(d) gemma3-27b kv-bits mixed", counted, phase="4i", config=cfg)
    finally:
        undo_w()
        undo_r()
    eng = run["engine"]
    got_bits = tuple(32 if seg.quant is None else seg.quant.bits
                     for seg in eng.pc.segments for _ in range(seg.n))
    waves, pre = eng.sched.decode_steps, len(eng.timing["prefill_s"])
    want_w = {4: 2 * n_local * (waves + pre), 8: 2 * (cfg.num_layers - n_local) * (waves + pre)}
    want_r = {4: 2 * n_local * waves, 8: 2 * (cfg.num_layers - n_local) * waves}
    if got_bits != want_bits or writes != want_w or reads != want_r:
        fail(f"phase 4i(d): segment bits {got_bits} (want {want_bits}); kernel 1 by bits "
             f"{writes} (want {want_w}), kernel 3 {reads} (want {want_r})")
    int8 = KVC.cache_bytes(KVC.make_paged_cache_config(cfg, "int8", eng.pc.page_size,
                                                       eng.pc.num_pages, eng.pc.blocks_per_seq))
    if (len(run["out"]) != 8 or eng.allocator.n_free != eng.pc.num_pages
            or not eng.cache_bytes < int8):
        fail(f"phase 4i(d): {len(run['out'])} of 8 answered, cache {eng.cache_bytes} B "
             f"(all-int8 {int8} B)")
    log(f"  phase 4i(d): segments {eng.pc.describe()}; kernel 1 by bits {writes}, kernel 3 by "
        f"bits {reads}; cache {eng.cache_bytes} B vs all-int8 {int8} B")
    run.update(engine=None, writes=writes, reads=reads, int8_bytes=int8)
    eng = None
    runs["d"] = run
    fp32 = _serve_run(torch, _serve_args("--kv-bits", "32", "--requests", "2", "--batch", "2",
                                         base=base, **kw),
                      "(d) gemma3-27b kv-bits 32, 2 requests", counted, phase="4i", config=cfg)
    if len(fp32["out"]) != 2:
        fail(f"phase 4i(d) fp32: {len(fp32['out'])} of 2 answered")
    fp32["near_ties"] = _check_fp32_tokens(torch, fp32, phase="4i(d)")
    kv_err = _check_fp32_kv(torch, fp32)
    log(f"  phase 4i(d) fp32: every token equals the full forward's argmax but "
        f"{fp32['near_ties']} near ties (gap < {SERVE_GAP_TOL}); every layer's cached K/V "
        f"within {kv_err:.3e} (relative) of the full forward's")
    fp32["engine"] = None
    runs["d-fp32"] = fp32
    return runs


# the fp32 arena's K/V against a full forward's: relative Frobenius error
# a layer (f32 both ways, summed in other orders)
SERVE_KV_RTOL = 1e-4


def _check_fp32_kv(torch, run, phase: str = "4i(d)") -> float:
    """Every fp32 request's cached K/V, every layer and written position
    (the prompt's from the banded prefill, the rest from windowed paged
    decode), against ``forward_with_kv`` over its prompt + generated
    tokens: a local layer that attended outside its window shifts the
    hidden state of every later layer.  Returns the worst relative
    error."""
    from repro_torch.models import transformer as T

    eng, worst = run["engine"], 0.0
    reqs = {s.req.rid: s.req for s in eng.sched.finished}
    for rid, toks in run["out"].items():
        seq = list(reqs[rid].prompt) + toks[:-1]
        _, kvs = T.forward_with_kv(eng.model, torch.tensor([seq], device=eng.device))
        pages = _request_pages(eng, rid)
        for j, seg in enumerate(eng.pc.segments):
            for i in range(seg.n):
                for tag, name in enumerate(("k", "v")):
                    got = eng.cache[f"seg{j}_{name}"][i, pages].flatten(0, 1)[:len(seq)]
                    want = kvs[seg.start + i][tag][0]
                    err = float((got - want).norm() / want.norm())
                    worst = max(worst, err)
                    if not err <= SERVE_KV_RTOL:
                        fail(f"phase {phase} fp32: request {rid} layer {seg.start + i} {name} "
                             f"relative error {err:.3e} against the full forward")
    return worst


def archs_buffer_rows(torch, train: dict, errs: dict, tag: str = "qwen3",
                      what: str = "qwen3-4b's buffer", chunked: bool = False) -> list:
    """Kernels 1, 2 and 3 at the flat exchange buffer of a ``train_cut``
    run (4i(a)'s qwen3-4b unless ``tag`` / ``what`` name another; [rows,
    512], int8, q = inf) as the two_phase exchange chains them, each held
    to its plain version on the same inputs and timed; ``launches`` is
    that run's count.  ``chunked``: the plain versions run in row chunks
    of 2**18 (at internvl2's 1.92e9 coordinates their intermediates at the
    full buffer do not fit beside the buffers), timed over all chunks."""
    from repro_torch.core.quantization import uniform_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_reduce import dequant_reduce_requantize_blocks
    from repro_torch.kernels.dequantize import dequantize_blocks
    from repro_torch.kernels.quantize import quantize_blocks

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    bucket, s, bits = 512, 15, 8
    rows = -(-train["n_live"] // bucket)
    n = rows * bucket
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lv = uniform_levels(s, dev)
    kw = dict(num_symbols=s + 2, q_is_inf=True, bits=bits)
    out = []

    def entry(name, ms, plain, err, nbytes, ops):
        kernel = kernel_key(name)
        out.append(kernel_row(name, train["counts"][kernel], ms, plain, max(err, errs[kernel]),
                              nbytes, ops, f"{rows} x {bucket}, int8, {what}"))

    def plain_of(fn, *full):
        """The plain version on the full arrays ``full``, whole or in chunks
        of their row axis (the first axis of length ``rows``)."""
        if not chunked:
            return _time_ms(torch, lambda: fn(*full), 2)

        def part(sl):
            return fn(*(t.narrow(list(t.shape).index(rows), sl.start, sl.stop - sl.start)
                        for t in full))

        return _time_ms(torch, lambda: _plain_chunks(torch, part, rows), 1)

    x = torch.randn((rows, bucket), generator=gen, device=dev)
    r = torch.rand((rows, bucket), generator=gen, device=dev)
    ms, got = _time_ms(torch, lambda: quantize_blocks(x, r, lv, **kw), 10)
    plain, want = plain_of(lambda x, r: ref.quantize_blocks_plain(x, r, lv, **kw), x, r)
    del x
    torch.cuda.empty_cache()
    err = _deq_err(torch, f"quantize int8 {what}", got, want, lv, bits)
    del want
    entry(f"quantize_blocks/{tag}-buffer-int8", ms, plain, err,
          4 * n + 4 * n + n + 4 * rows, n * (10 + 2 * s))
    P, N = got[0].unsqueeze(0), got[1].unsqueeze(0)
    del got
    ms, got = _time_ms(torch, lambda: dequant_reduce_requantize_blocks(
        P, N, lv, r, num_workers=1, **kw), 10)
    plain, want = plain_of(lambda P, N, r: ref.dequant_reduce_requantize_blocks_plain(
        P, N, lv, r, **kw), P, N, r)
    del r, P, N
    torch.cuda.empty_cache()
    err = _deq_err(torch, f"dequant_reduce_requantize {what}", got, want, lv, bits)
    del want
    entry(f"dequant_reduce_requantize_blocks/{tag}-buffer", ms, plain, err,
          n + 4 * rows + 4 * n + n + 4 * rows, n * (14 + 2 * s))
    payload, norms = got
    ms, got = _time_ms(torch, lambda: dequantize_blocks(payload, norms, lv, num_symbols=s + 2,
                                                        bits=bits), 10)
    plain, want = plain_of(lambda p, q: ref.dequantize_blocks_plain(p, q, lv, bits=bits),
                           payload, norms)
    err = _close(torch, f"dequantize {what}", got, want)
    entry(f"dequantize_blocks/{tag}-buffer", ms, plain, err, n + 4 * rows + 4 * n, 3 * n)
    del payload, norms, got, want
    torch.cuda.empty_cache()
    return out


def archs_kernel_rows(torch, train: dict, serve: dict, errs: dict) -> list:
    """Phase 4i's kernel rows: kernels 1-3 at (a)'s buffer, and kernels 1
    and 3 at the cache's new widths: qwen3-4b's 1024 features (8 kv heads x
    128; a wave's write [16, 1024], its read [16 x 576, 1024]) with (c)'s
    int4 counts, and gemma3-27b's 2048 (16 x 128; [8, 2048] and
    [8 x 1600, 2048]) with (d)'s counts by bits."""
    c = serve["c"]["counts"]
    rows = archs_buffer_rows(torch, train, errs)
    rows += kv_kernel_rows(torch, 1024, {"write": 16}, 16 * 576,
                           {8: (0, 0), 4: (c["quantize_blocks"], c["dequantize_blocks"])}, errs,
                           suffix="-f1024")
    d = serve["d"]
    rows += kv_kernel_rows(torch, 2048, {"write": 8}, 8 * 1600,
                           {b: (d["writes"][b], d["reads"][b]) for b in (8, 4)}, errs,
                           suffix="-f2048")
    return rows


# ---------------------------------------------------------------------------
# phase 4j: the exchange's layouts (bucketed, per-call, leafwise)
# ---------------------------------------------------------------------------

LAYOUT_BUCKETS = 4
LAYOUT_RUNS = (  # (tag, steps, extra train flags)
    ("bucketed", 3, dict(compression="int8", num_buckets=LAYOUT_BUCKETS, overlap="bucketed")),
    ("defer_tail", 3, dict(compression="int8", num_buckets=LAYOUT_BUCKETS,
                           overlap="defer_tail")),
    ("no-plan", 2, dict(compression="int8", no_exchange_plan=True)),
    ("leafwise-int8", 2, dict(compression="int8", compress_mode="leafwise")),
    ("leafwise-int4", 2, dict(compression="int4", compress_mode="leafwise")),
)
BUCKET_KERNELS = ("quantize_blocks", "dequant_reduce_requantize_blocks", "dequantize_blocks")
LEAF_KERNELS = ("quantize_blocks", "dequant_reduce_blocks")


def _bucket_sums(trace, buckets: int) -> list:
    """The recorder's bytes per ``b{i}/`` prefix; fails on an operand
    without one."""
    sums = [0] * buckets
    for name, nbytes in trace:
        if not name.startswith("b") or "/" not in name:
            fail(f"phase 4j: recorder operand {name!r} is not under a bucket prefix")
        sums[int(name.split("/")[0][1:])] += nbytes
    return sums


def layouts_path(torch, batch: int, seq: int, shapes: list, fixed: dict) -> dict:
    """Phase 4j: tinyllama-1.1b at full width (bf16 layers, K = 1) through
    ``run()``, qgenx ``de``, the launch counts reset and the wire recorder
    on around each run:

    (a) 3 int8 two_phase steps with ``--num-buckets 4 --overlap bucketed``:
        kernels 1-3 once per bucket and exchange (24 each), ``wire_bytes``
        2 x the sum of ``bucket_wire_bytes_tree``, the recorder's ``b{i}/``
        operands per bucket 6 x its entry, finite losses;
    (b) the same with ``defer_tail``; then on a full-width gradient-shaped
        tree (f32, random) two exchanges: the first applies an all-zero
        tail, the second the first's ``pending`` (its bytes printed);
    (c) 2 steps with ``--no-exchange-plan`` (kernels 1-3 once an
        exchange: ``pmean_tree`` takes the plan under either layout); then
        on the same tree the per-call config's mean equals the planned one
        bit for bit under the same noise;
    (d) 2 steps each with ``--compress-mode leafwise`` at int8 and int4:
        kernels 1 and 4 once per leaf and exchange, no other kernel,
        ``wire_bytes`` the leafwise bytes; then one exchange of the tree
        with ``allreduce_fallback=True``: kernels 1 and 3 once per leaf;
    (e) each of (a)-(d) at reduced size on the card and on the CPU, the
        same weights and noise (``card_vs_cpu_runs``).

    Prints step times and peaks beside phase 4a's int8 run (``fixed``).
    Returns the runs' launch counts (summed), each run's own, and the
    leafwise shapes for phase 5."""
    from repro_torch.core import exchange as xmod
    from repro_torch.core.exchange import ExchangeConfig, make_exchange
    from repro_torch.core.noise import GeneratorNoise
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import build_exchange_config, run

    meta = [torch.empty(s, device="meta") for s in shapes]  # shapes for the accounting
    n_leaves = len(shapes)
    total = {name: 0 for name in cuda.KERNELS}
    by_run = {}
    for tag, steps, flags in LAYOUT_RUNS:
        args = _train_args(arch="tinyllama-1.1b", dtype="bfloat16", batch=batch, seq=seq,
                           device="cuda", optimizer="qgenx", method="de", steps=steps,
                           **flags)
        ex = make_exchange(build_exchange_config(args))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        xmod.wire_trace_start()
        out = run(args, log=lambda m: log(f"  {m}"))
        trace = xmod.wire_trace_stop()
        counts = cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        calls = 2 * steps
        per_bucket = ex.bucket_wire_bytes_tree(meta, 1) if ex.cfg.overlap != "off" else None
        want_wire = ex.wire_bytes_tree(meta, 1)
        if per_bucket is not None and want_wire != sum(per_bucket):
            fail(f"phase 4j {tag}: wire_bytes_tree {want_wire} != sum {per_bucket}")
        if out["wire_bytes"] != [2 * want_wire] * steps:
            fail(f"phase 4j {tag}: wire_bytes {out['wire_bytes']} != 2 x {want_wire}")
        if sum(b for _, b in trace) != calls * want_wire:
            fail(f"phase 4j {tag}: the recorder saw {sum(b for _, b in trace)} bytes, not "
                 f"{calls} x {want_wire}")
        if per_bucket is not None:
            sums = _bucket_sums(trace, LAYOUT_BUCKETS)
            if sums != [calls * b for b in per_bucket]:
                fail(f"phase 4j {tag}: recorder per bucket {sums} != {calls} x {per_bucket}")
        if ex.cfg.mode == "leafwise":
            want = {k: calls * n_leaves if k in LEAF_KERNELS else 0 for k in cuda.KERNELS}
        else:
            per = LAYOUT_BUCKETS if ex.cfg.overlap != "off" else 1
            want = {k: calls * per if k in BUCKET_KERNELS else 0 for k in cuda.KERNELS}
        if counts != want:
            fail(f"phase 4j {tag}: launches {counts}, want {want}")
        if not all(math.isfinite(v) for v in out["loss"]):
            fail(f"phase 4j {tag}: non-finite loss {out['loss']}")
        pending = out["ex_state"].pending
        log(f"  phase 4j {tag}: loss={out['loss']} step_s={out['step_s']} peak_bytes={peak} "
            f"wire_bytes={out['wire_bytes'][0]:.0f}"
            + (f" per bucket {per_bucket}" if per_bucket else "")
            + f" pending {pending.numel() * 4} B launches "
            f"{[(k, v) for k, v in counts.items() if v]}")
        log(f"phase 4j: {tag} step_s {out['step_s']} vs 4a int8 {fixed['step_s']}; peak "
            f"{peak} bytes (4a int8: {fixed['peak_bytes']})")
        by_run[tag] = {"counts": counts, "step_s": out["step_s"], "peak_bytes": peak}
        for k, v in counts.items():
            total[k] += v
        del out, pending
    gc.collect()
    torch.cuda.empty_cache()

    # exchange-level checks on a full-width gradient-shaped tree
    gen = torch.Generator(device="cuda")
    gen.manual_seed(51)
    tree = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    int8 = QuantConfig(num_levels=15, bits=8, bucket_size=512)
    ex = make_exchange(ExchangeConfig(quant=int8, num_buckets=LAYOUT_BUCKETS,
                                      overlap="defer_tail"))
    st = ex.init_state("cuda", template=tree, num_workers=1)
    tail = ex.bucket_partition(tree)[0]
    if st.pending.abs().max() != 0:
        fail("phase 4j (b): the first pending is not zero")
    mean, st1 = ex.pmean_tree(tree, st, GeneratorNoise.seeded(52, "cuda"))
    if any(mean[i].abs().max() != 0 for i in tail):
        fail("phase 4j (b): the first call's tail is not zero")
    del mean
    mean, st2 = ex.pmean_tree(tree, st1, GeneratorNoise.seeded(53, "cuda"))
    sub = [tree[i] for i in tail]
    want = ex.plan_for(sub).unpack(st1.pending, sub)
    if not all(torch.equal(mean[i], w) for i, w in zip(tail, want)):
        fail("phase 4j (b): the second call's tail is not the first call's pending")
    log(f"  phase 4j (b): defer_tail over {sum(t.numel() for t in tree)} coordinates: the "
        f"first tail zero, the second the first pending ({st1.pending.numel() * 4} B, tail "
        f"bucket leaves {list(tail)})")
    del mean, want, st, st1, st2, sub
    gc.collect()
    torch.cuda.empty_cache()
    means = []
    for use_plan in (True, False):
        ex = make_exchange(ExchangeConfig(quant=int8, use_plan=use_plan))
        mean, _ = ex.pmean_tree(tree, ex.init_state("cuda"), GeneratorNoise.seeded(54, "cuda"))
        means.append(mean)
        del mean
    if not all(torch.equal(a, b) for a, b in zip(*means)):
        fail("phase 4j (c): the per-call mean differs from the planned one")
    log("  phase 4j (c): the per-call layout's mean equals the planned one bit for bit")
    del means
    gc.collect()
    torch.cuda.empty_cache()
    ex = make_exchange(ExchangeConfig(quant=int8, mode="leafwise", allreduce_fallback=True))
    cuda.reset_launch_counts()
    xmod.wire_trace_start()
    mean, _ = ex.pmean_tree(tree, ex.init_state("cuda"), GeneratorNoise.seeded(55, "cuda"))
    trace = xmod.wire_trace_stop()
    counts = cuda.launch_counts()
    want = {k: n_leaves if k in ("quantize_blocks", "dequantize_blocks") else 0
            for k in cuda.KERNELS}
    if counts != want or not all(torch.isfinite(m).all() for m in mean):
        fail(f"phase 4j (d): allreduce_fallback launched {counts}, want {want}")
    if sum(b for _, b in trace) != ex.wire_bytes_tree(meta, 1):
        fail("phase 4j (d): allreduce_fallback's recorder differs from wire_bytes_tree")
    log(f"  phase 4j (d): allreduce_fallback, one exchange: kernels 1 and 3 {n_leaves} "
        f"launches each, {sum(b for _, b in trace)} B of f32 estimates")
    for k, v in counts.items():
        total[k] += v
    by_run["fallback"] = {"counts": counts}
    del mean, tree
    gc.collect()
    torch.cuda.empty_cache()

    # (e) card vs cpu at reduced size, the same weights and noise
    small = QuantConfig(num_levels=15, bits=8, bucket_size=512)
    small4 = QuantConfig(num_levels=5, bits=4, bucket_size=512)
    card_vs_cpu_runs(torch, (
        (ExchangeConfig(quant=small, num_buckets=LAYOUT_BUCKETS, overlap="bucketed"), 1e-3),
        (ExchangeConfig(quant=small, num_buckets=LAYOUT_BUCKETS, overlap="defer_tail"), 1e-3),
        (ExchangeConfig(quant=small, use_plan=False), 1e-3),
        (ExchangeConfig(quant=small, mode="leafwise"), 1e-3),
        (ExchangeConfig(quant=small4, mode="leafwise"), 1e-3),
        (ExchangeConfig(quant=small, mode="leafwise", allreduce_fallback=True), 1e-3)))
    return {"total": total, "runs": by_run}


def leafwise_kernel_rows(torch, shapes: list, layouts: dict, errs: dict) -> list:
    """Kernels 1 and 4 as the leafwise exchange runs them (int8, q = inf,
    K = 1, bucket = the leaf's trailing dim) at its two extreme leaves of
    tinyllama-1.1b: the widest rows (``unembed``, 2,048 x 32,000) and the
    most rows (the leaf with the most trailing rows: the attention's query
    projection, 22 x 2,048 x 32 rows of 64).  Each held to its plain
    version on the same inputs and timed; ``launches`` is phase 4j's int8
    leafwise run's count at that leaf (one an exchange; the fallback
    exchange's kernel 1 launch included for kernel 1)."""
    from repro_torch.core.quantization import uniform_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_reduce import dequant_reduce_blocks
    from repro_torch.kernels.quantize import quantize_blocks

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    s, bits = 15, 8
    lv = uniform_levels(s, dev)
    kw = dict(num_symbols=s + 2, q_is_inf=True, bits=bits)
    runs = layouts["runs"]
    per_leaf = runs["leafwise-int8"]["counts"]["quantize_blocks"] // len(shapes)
    widest = max(shapes, key=lambda sh: sh[-1])
    most = max(shapes, key=lambda sh: math.prod(sh[:-1]))
    out = []
    for what, shape in (("widest", widest), ("most-rows", most)):
        d = shape[-1]
        n_rows = math.prod(shape[:-1])
        n = n_rows * d
        x = torch.randn((n_rows, d), generator=gen, device=dev)
        r = torch.rand((n_rows, d), generator=gen, device=dev)
        ms, got = _time_ms(torch, lambda: quantize_blocks(x, r, lv, **kw), 10)
        plain, want = _time_ms(torch, lambda: ref.quantize_blocks_plain(x, r, lv, **kw), 2)
        del x, r
        torch.cuda.empty_cache()
        err = _deq_err(torch, f"quantize leafwise {what}", got, want, lv, bits)
        del want
        out.append(kernel_row(f"quantize_blocks/leafwise-{what}", per_leaf + 1, ms, plain,
                              max(err, errs["quantize_blocks"]), 4 * n + 4 * n + n + 4 * n_rows,
                              n * (10 + 2 * s), f"{n_rows} x {d}, int8, leafwise {shape}"))
        P, N = got[0].unsqueeze(0), got[1].unsqueeze(0)
        del got
        ms, got = _time_ms(torch, lambda: dequant_reduce_blocks(P, N, lv, num_symbols=s + 2,
                                                                num_workers=1, bits=bits), 10)
        plain, want = _time_ms(torch, lambda: ref.dequant_reduce_blocks_plain(P, N, lv,
                                                                              bits=bits), 2)
        err = _close(torch, f"dequant_reduce leafwise {what}", got, want)
        out.append(kernel_row(f"dequant_reduce_blocks/leafwise-{what}", per_leaf, ms, plain,
                              max(err, errs["dequant_reduce_blocks"]), n + 4 * n_rows + 4 * n,
                              4 * n, f"{n_rows} x {d}, int8, leafwise {shape}"))
        del P, N, got, want
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4k: the MoE and VLM families (llama4-maverick-400b-a17b, internvl2-26b)
# ---------------------------------------------------------------------------

LLAMA4, INTERNVL2 = "llama4-maverick-400b-a17b", "internvl2-26b"
# (a)'s depth: 2 of internvl2-26b's 48 layers at full width, 1,917,431,808
# parameters and 1,917,462,528 exchanged coordinates, so the int8 payload
# (1.92e9 bytes) stays under 2**31 bytes; a third layer would pass it
VLM_TRAIN_LAYERS = 2
# (c)'s cut: one period of llama4's pattern (chunk / MoE-chunk / chunk /
# MoE-global) and 16 of its 128 experts (Llama-4-Scout-17B-16E's count, the
# config's own citation): 6.85e9 parameters, 27.4 GB in f32, where the
# first two whole layers at 128 experts are 18.55e9 parameters, 74.2 GB
MOE_SERVE_LAYERS, MOE_SERVE_EXPERTS = 4, 16
# (d)'s depth: 12 of internvl2-26b's 48 layers (5.83e9 parameters, 23.3 GB in f32)
VLM_SERVE_LAYERS = 12
FAMILY_SERVE_ARGV = ("--batch", "8", "--requests", "8", "--prompt-len", "512", "--gen", "64",
                     "--page-size", "16")
# (b)'s and (e)'s model: llama4's reduced() at 5 layers (one period of the
# pattern and a chunk tail layer: the CPU tests' llama4-5)
MOE_SMALL_LAYERS = 5
# (b)'s bars: losses and params within MOE_CARD_CPU_RTOL (sound runs on
# the H100 read 7e-8 on the losses and 2.5e-8 on the params), and no
# expert choice flipped whose top-two margin on the CPU is above
# MOE_FLIP_MARGIN (a flip inside it is a tie at f32 rounding, reported)
MOE_CARD_CPU_RTOL = 1e-6
MOE_FLIP_MARGIN = 1e-5


def _moe_small(torch):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LLAMA4).reduced(), num_layers=MOE_SMALL_LAYERS)


def moe_card_vs_cpu(torch, batch: int, seq: int, steps: int = 3) -> dict:
    """(b): llama4-5 (chunk 64, 4 experts top-1 with a shared expert), f32,
    batch x seq (8 chunks of 64 at seq 512), ``steps`` qgenx ``de`` steps
    with the int8 two_phase exchange on the card (CUDA kernels 1-3, each
    launched twice a step) and on the CPU (plain versions), the same
    weights, batches and noise.  Every MoE layer's expert choices are
    compared first: a choice that flips is reported with its token and the
    margin between its top two probabilities on the CPU, and fails the
    phase if that margin is above MOE_FLIP_MARGIN.  Then losses and params
    within MOE_CARD_CPU_RTOL.  Returns the flips and the card run's
    counts."""
    import copy

    import numpy as np

    from repro_torch.core.exchange import ExchangeConfig, make_exchange
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.data.pipeline import make_pipeline, to_device
    from repro_torch.kernels import cuda
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import build
    from repro_torch.optim import qgenx as qgenx_opt
    from repro_torch.optim.optimizers import OptimizerConfig

    cfg = _moe_small(torch)
    base = build(cfg, seed=0, device="cpu")
    pipe = make_pipeline(cfg.vocab_size, batch, seq, seed=0)
    batches = [next(pipe) for _ in range(steps)]
    ex_cfg = ExchangeConfig(compressor="qgenx", mode="two_phase",
                            quant=QuantConfig(num_levels=15, bits=8, bucket_size=512))
    opt_cfg = OptimizerConfig(name="qgenx", gamma_scale=0.02, method="de")
    route = MOE.route
    results = {}
    try:
        for dev in ("cpu", "cuda"):
            seen = []

            def recording(p, c, xt, seen=seen):
                probs, gates, idx = route(p, c, xt)
                seen.append((probs.detach().cpu(), idx.detach().cpu()))
                return probs, gates, idx

            MOE.route = recording
            model = copy.deepcopy(base).to(dev)
            ex = make_exchange(ex_cfg)
            step = make_train_step(model, opt_cfg, ex)
            opt_state = qgenx_opt.init_qgenx_state(opt_cfg, model.param_leaves())
            ex_state = ex.init_state(dev, template=model.param_leaves(), num_workers=1)
            noise = _NumpyNoise(7)
            losses = []
            cuda.reset_launch_counts()
            for b in batches:
                opt_state, ex_state, m = step(opt_state, ex_state, to_device(b, dev), noise)
                losses.append(float(m["loss"]))
            counts = cuda.launch_counts()
            results[dev] = (np.array(losses), [p.detach().cpu() for p in model.param_leaves()],
                            seen, counts)
            del model, opt_state, ex_state
    finally:
        MOE.route = route
    (lc, pc, sc, _), (lg, pg, sg, counts) = results["cpu"], results["cuda"]
    want = {k: 2 * steps if k in EXCHANGE_KERNELS else 0 for k in counts}
    if counts != want:
        fail(f"phase 4k(b): card launches {counts} != {want}")
    if len(sc) != len(sg) or len(sc) != 2 * 2 * steps:  # 2 MoE layers, 2 gradients a step
        fail(f"phase 4k(b): {len(sg)} routing calls on the card, {len(sc)} on the CPU")
    flips = []
    for call, ((probs_c, idx_c), (_, idx_g)) in enumerate(zip(sc, sg)):
        for t in torch.nonzero(idx_c[:, 0] != idx_g[:, 0]).flatten().tolist():
            top = torch.topk(probs_c[t], 2).values
            flips.append((call, t, int(idx_c[t, 0]), int(idx_g[t, 0]),
                          float(top[0] - top[1])))
    for call, t, a, b, margin in flips[:20]:
        log(f"  phase 4k(b): routing call {call} (step {call // 4}, MoE layer {call % 2}) "
            f"token {t}: expert {a} on the CPU, {b} on the card; top-two margin {margin:.3e}")
    n_tok = sum(int(idx.numel()) for _, idx in sc)
    wide = [f for f in flips if f[4] > MOE_FLIP_MARGIN]
    if wide:
        fail(f"phase 4k(b): {len(wide)} expert choices flipped card vs cpu with a top-two "
             f"margin above {MOE_FLIP_MARGIN:g} (largest {max(f[4] for f in wide):.3e})")
    if not np.allclose(lg, lc, rtol=MOE_CARD_CPU_RTOL, atol=0):
        fail(f"phase 4k(b) card vs cpu loss: {lg} vs {lc} ({len(flips)} routing flips)")
    worst = max(float((a - b).norm() / b.norm()) for a, b in zip(pg, pc))
    if worst > MOE_CARD_CPU_RTOL:
        fail(f"phase 4k(b) card vs cpu params: rel err {worst:.3e} ({len(flips)} routing "
             "flips)")
    log(f"  phase 4k(b) llama4-5 card vs cpu (qgenx de int8 two_phase, {steps} steps, "
        f"{batch} x {seq}): {len(flips)} of {n_tok} expert choices flipped; losses {lg} vs "
        f"{lc}, worst param rel err {worst:.3e}; card launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"flips": flips, "counts": counts, "choices": n_tok}


def _moe_serve_cut(torch, reduced=False):
    from repro_torch.configs import get_config

    full = get_config(LLAMA4)
    base = full.reduced() if reduced else full
    return dataclasses.replace(base, num_layers=MOE_SERVE_LAYERS,
                               num_experts=min(base.num_experts, MOE_SERVE_EXPERTS))


def _release_served(run: dict, tag: str, ratio: float) -> None:
    """A 4k serving run's checks (every request answered, every page freed,
    the cache ``ratio`` x below fp32); then its engine and model are let
    go, so that the next run's peak is its own."""
    eng = run["engine"]
    if len(run["out"]) != 8 or eng.allocator.n_free != eng.pc.num_pages:
        fail(f"phase 4k({tag}): {len(run['out'])} of 8 answered")
    if eng.fp32_cache_bytes / eng.cache_bytes < ratio:
        fail(f"phase 4k({tag}): cache {eng.cache_bytes} B vs fp32 {eng.fp32_cache_bytes} B")
    run.update(engine=None, cache_bytes=eng.cache_bytes, fp32_cache_bytes=eng.fp32_cache_bytes)


def families_serve(torch, reduced=False, device="cuda") -> dict:
    """(c), (d): ``repro_torch.launch.serve.run``, f32, random weights from
    seed 0, FAMILY_SERVE_ARGV (8 requests of 510-512 + 64 tokens, 8 slots),
    each run's model freed before the next:

    (c) llama4-maverick-400b-a17b at its published widths cut to
        MOE_SERVE_LAYERS layers and MOE_SERVE_EXPERTS experts: at
        ``--kv-bits mixed`` (the chunk-local layers int4, the global layer
        int8: kernel 1 and 3's launches by bits) and at ``--kv-bits 8``;
        then 2 requests at ``--kv-bits 32`` with ``capacity_factor`` = E,
        so that no token is dropped and a request's tokens depend on
        nothing else in its batch (ROADMAP C14): its tokens equal a full
        forward's argmax but at near ties and its cached K/V, every layer,
        ``forward_with_kv``'s within SERVE_KV_RTOL (the 576 positions lie
        inside one chunk of 8192, so chunk prefill and windowed decode
        agree);
    (d) internvl2-26b cut to VLM_SERVE_LAYERS layers at ``--kv-bits 8``,
        served by its tokens alone (ROADMAP C15).

    Every request answers, every page is freed and the quantized caches
    are below fp32.  Returns the runs."""
    from repro_torch.configs import get_config
    from repro_torch.serve import kv_cache as KVC

    counted = device == "cuda"
    kw = dict(reduced=reduced, device=device)
    # reduced: the whole sequence inside the chunk of 64, as at full width
    small = ("--prompt-len", "40", "--gen", "8") if reduced else ()
    cfg = _moe_serve_cut(torch, reduced)
    full = get_config(LLAMA4)
    log(f"  reduced: {LLAMA4} num_layers {full.num_layers} -> {cfg.num_layers}, num_experts "
        f"{full.num_experts} -> {cfg.num_experts} at full width (Llama-4-Scout's expert count, "
        f"the config's citation; {cfg.param_count()} parameters, "
        f"{cfg.param_count() * 4 / 1e9:.1f} GB in f32: two whole layers at 128 experts are "
        f"74.2 GB of the card's 80; serve phase only)")
    base = FAMILY_SERVE_ARGV + ("--arch", LLAMA4) + small
    want_bits = KVC.layer_bit_policy(cfg, "mixed")
    if want_bits != (4, 4, 4, 8):
        fail(f"phase 4k(c): layer_bit_policy(mixed) = {want_bits}")
    n_local = want_bits.count(4)
    runs = {}
    writes, undo_w = _bits_tally(KVC, "quantize_blocks")
    reads, undo_r = _bits_tally(KVC, "dequantize_blocks")
    try:
        run = _serve_run(torch, _serve_args("--kv-bits", "mixed", base=base, **kw),
                         "(c) llama4 kv-bits mixed", counted, phase="4k", config=cfg)
    finally:
        undo_w()
        undo_r()
    eng = run["engine"]
    waves, pre = eng.sched.decode_steps, len(eng.timing["prefill_s"])
    want_w = {4: 2 * n_local * (waves + pre), 8: 2 * (cfg.num_layers - n_local) * (waves + pre)}
    want_r = {4: 2 * n_local * waves, 8: 2 * (cfg.num_layers - n_local) * waves}
    if writes != want_w or reads != want_r:
        fail(f"phase 4k(c): kernel 1 by bits {writes} (want {want_w}), kernel 3 {reads} "
             f"(want {want_r})")
    run.update(writes=writes, reads=reads)
    runs["c-mixed"] = run
    eng = None
    _release_served(run, "c-mixed", 4.0)
    run = _serve_run(torch, _serve_args("--kv-bits", "8", base=base, **kw),
                     "(c) llama4 kv-bits 8", counted, phase="4k", config=cfg)
    runs["c-int8"] = run
    _release_served(run, "c-int8", 2.0)
    no_drop = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    fp32 = _serve_run(torch, _serve_args("--kv-bits", "32", "--requests", "2", "--batch", "2",
                                         base=base, **kw),
                      "(c) llama4 kv-bits 32, 2 requests, capacity_factor = E", counted,
                      phase="4k", config=no_drop)
    if len(fp32["out"]) != 2:
        fail(f"phase 4k(c) fp32: {len(fp32['out'])} of 2 answered")
    fp32["near_ties"] = _check_fp32_tokens(torch, fp32, phase="4k(c)")
    kv_err = _check_fp32_kv(torch, fp32, phase="4k(c)")
    log(f"  phase 4k(c) fp32: every token equals the full forward's argmax but "
        f"{fp32['near_ties']} near ties (gap < {SERVE_GAP_TOL}); every layer's cached K/V "
        f"within {kv_err:.3e} (relative) of the full forward's")
    fp32["engine"] = None
    runs["c-fp32"] = fp32
    full = get_config(INTERNVL2)
    vcfg = dataclasses.replace(full.reduced() if reduced else full,
                               num_layers=VLM_SERVE_LAYERS)
    log(f"  reduced: {INTERNVL2} num_layers {full.num_layers} -> {vcfg.num_layers} at full "
        f"width ({vcfg.param_count() * 4 / 1e9:.1f} GB in f32; serve phase only)")
    run = _serve_run(torch, _serve_args("--kv-bits", "8", base=FAMILY_SERVE_ARGV + (
        "--arch", INTERNVL2) + small, **kw), "(d) internvl2 kv-bits 8, tokens only", counted,
        phase="4k", config=vcfg)
    runs["d"] = run
    _release_served(run, "d", 2.0)
    return runs


def moe_serve_card_vs_cpu(torch) -> None:
    """(e): llama4-5 at ``--kv-bits mixed`` through ``ServeEngine``, the same
    weights (made on the CPU) on the card and on the CPU, 8 requests of 96
    prompt tokens (past the chunk of 64; one ending in a run of one token,
    which crowds an expert) + 16, 4 slots: the cache draws are keyed by
    request and position on either device, so the tokens must be equal."""
    import copy

    import numpy as np

    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request

    cfg = _moe_small(torch)
    base = build(cfg, seed=0, device="cpu")
    for p in base.parameters():
        p.requires_grad_(False)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, 96 - (r % 3)).tolist() for r in range(8)]
    prompts[3][48:] = [prompts[3][48]] * (len(prompts[3]) - 48)
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        eng = ServeEngine(cfg, model, policy="mixed", page_size=16, n_slots=4, max_len=112,
                          seed=0)
        out[dev] = eng.run([Request(r, list(p), 16) for r, p in enumerate(prompts)])
        del eng, model
    if out["cpu"] != out["cuda"]:
        diff = [r for r in out["cpu"] if out["cpu"][r] != out["cuda"].get(r)]
        fail(f"phase 4k(e): requests {diff} differ on the card and the CPU")
    log(f"  phase 4k(e) llama4-5 mixed, card vs cpu: {len(out['cpu'])} requests, "
        f"{sum(len(v) for v in out['cpu'].values())} tokens, equal")


def families_path(torch, batch: int, seq: int, fixed: dict) -> dict:
    """Phase 4k: (a) internvl2-26b trained at full width cut to
    VLM_TRAIN_LAYERS layers (``train_cut``: bf16 layers, the 256 stubbed
    prefix embeds, 3 qgenx ``de`` int8 two_phase steps; step times and peak
    printed beside 4a's ``fixed``); (b) ``moe_card_vs_cpu``; (c), (d)
    ``families_serve``; (e) ``moe_serve_card_vs_cpu``.  Returns (a)'s and
    the serving runs' numbers."""
    t0 = time.perf_counter()
    # the bound is what fits on the card (80 GB less 2 GB), not a target:
    # 59 % of the coordinates are the f32 embeddings (4a's are 6 %)
    train = train_cut(torch, INTERNVL2, VLM_TRAIN_LAYERS, batch, seq, "4k(a)",
                      "its int8 payload under 2**31 bytes; train phase only", max_peak=78e9)
    rows = -(-train["n_live"] // 512)
    if rows * 512 >= 2**31:
        fail(f"phase 4k(a): {rows} x 512 payload bytes reach 2**31")
    log(f"  phase 4k(a) internvl2-26b: step_s {train['step_s']} (4a int8: "
        f"{fixed['step_s']}), peak {train['peak']} B (4a int8: {fixed['peak_bytes']} B); payload "
        f"{rows * 512} B; {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe = moe_card_vs_cpu(torch, batch, seq)
    log(f"  phase 4k(b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve = families_serve(torch)
    log(f"  phase 4k(c), (d) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_serve_card_vs_cpu(torch)
    log(f"  phase 4k(e) took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "moe": moe, "serve": serve}


def families_kernel_rows(torch, fam: dict, errs: dict) -> list:
    """Phase 4k's kernel rows: kernels 1-3 at (a)'s internvl2-26b buffer
    ([3,745,044 x 512]; the plain versions in row chunks), and kernels 1 and
    3 at the cache shapes no row had: 1024 features (8 kv heads x 128, both
    families), a wave's write [8, 1024], a prefill's [512, 1024] and a
    wave's read [8 x 576, 1024], with (c)'s and (d)'s counts by bits."""
    rows = archs_buffer_rows(torch, fam["train"], errs, tag="internvl2",
                             what="internvl2-26b's buffer (4k(a), 2 layers)", chunked=True)
    s = fam["serve"]
    mixed = s["c-mixed"]
    by_bits = {8: (mixed["writes"][8] + s["c-int8"]["counts"]["quantize_blocks"]
                   + s["d"]["counts"]["quantize_blocks"],
                   mixed["reads"][8] + s["c-int8"]["counts"]["dequantize_blocks"]
                   + s["d"]["counts"]["dequantize_blocks"]),
               4: (mixed["writes"][4], mixed["reads"][4])}
    rows += kv_kernel_rows(torch, 1024, {"write": 8, "prefill": 512}, 8 * 576, by_bits, errs,
                           suffix="-f1024-b8")
    return rows


# ---------------------------------------------------------------------------
# phase 5: kernel times at the main-path shapes
# ---------------------------------------------------------------------------


DEVICE_MS_ATTEMPTS = 3  # see device_ms


def _time_ms(torch, fn, reps: int, flush=None):
    """(ms per call, the last call's output).  With ``flush`` (see
    :func:`l2_flush`), each call runs after it and is timed alone, between
    its own pair of events."""
    fn()
    torch.cuda.synchronize()
    if flush is not None:
        pairs = []
        for _ in range(reps):
            flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps - 1):
        fn()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def l2_flush(torch):
    """A call that reads a buffer of twice the card's L2, so that what a
    kernel timed after it reads comes from HBM: a working set that fits in
    L2 (a wave's KV-cache rows) would otherwise stay there across
    back-to-back launches and be timed against an HBM bound it does not
    pay.  Its reduction kernel is no kernel that :func:`device_ms` counts."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) or L2_BYTES
    buf = torch.ones(2 * l2 // 4, device="cuda")
    return lambda: buf.sum()


def device_ms(torch, fn, kernel: str, reps: int, flush=None) -> float:
    """The device time of one launch of ``kernel`` (a substring of the CUDA
    kernel's name): ``reps`` calls of ``fn`` under ``torch.profiler``, the
    kernel's device time summed by ``key_averages()`` over the launches the
    profiler recorded, divided by their count.

    A profiler started cold drops the first launches it sees (CUPTI comes
    up behind the host: 16-21 of 50 short launches were lost that way), so
    the ``reps`` calls are the active step of a schedule whose warm-up step
    makes the same calls unrecorded.  A measurement that still records
    fewer than half the launches is taken again, up to
    ``DEVICE_MS_ATTEMPTS`` times, and then fails.  With ``flush`` (see
    :func:`l2_flush`), each call runs after it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, DEVICE_MS_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the recorded one
                for _ in range(reps):
                    if flush is not None:
                        flush()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us, launches = 0.0, 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                us += getattr(evt, "device_time_total", 0.0) or getattr(evt, "cuda_time_total", 0.0)
                launches += evt.count
        if launches >= reps // 2 and us > 0.0:
            break
        log(f"    profiler: attempt {attempt} saw {launches} launches of {kernel} "
            f"({us} us of device time) in {reps} calls")
    else:
        fail(f"the profiler saw {launches} launches of {kernel} ({us} us of device time) "
             f"in {reps} calls, {DEVICE_MS_ATTEMPTS} times")
    log(f"    profiler: {launches} of {reps} launches recorded, {us:.1f} us of device time")
    return us / launches / 1e3


def kernel_key(name: str) -> str:
    """The launch counter (and REPLACES key) of a row name such as
    ``quantize_blocks/int8`` or ``quantize_blocks/prng/int8``."""
    return name if name in REPLACES else name.rsplit("/", 1)[0]


def kernel_row(name, launches, ms, plain_ms, err, nbytes, ops, what, int_ops=0) -> dict:
    """One entry of the ``kernels`` line: the bound is the largest of the
    bytes over the HBM rate, the f32 operations over the f32 rate and the
    32-bit integer operations (the device PRNG's) over the integer rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    bound = max(t_bytes, t_ops)
    row = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
           "replaces": REPLACES[kernel_key(name)], "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    log(f"  {name} [{what}]: {ms:.4f} ms (bound {bound:.4f} ms by {row['bound_by']}: "
        f"{nbytes / 1e9:.4f} GB -> {t_bytes:.4f} ms, {ops:.4g} f32 and {int_ops:.4g} int32 "
        f"ops -> {t_ops:.4f} ms; plain {plain_ms:.4f} ms); launches {launches}, "
        f"max abs err vs plain {err:.3e}")
    return row


def _deq_err(torch, name, got, want, levels, bits, chunk=1 << 18):
    """Max abs difference of two (payload, norms) pairs once dequantized by
    the plain version, in row chunks (a full buffer dequantized twice would
    take 8.8 GB); fails unless the payloads agree as ``_check_indices``
    requires (q = inf: byte for byte)."""
    from repro_torch.kernels import ref

    (pg, ng), (pw, nw) = got, want
    _check_indices(torch, name, pg, pw, bits, True, ng, nw)
    _close(torch, f"{name} norms", ng, nw)
    err = 0.0
    for i in range(0, pg.shape[0], chunk):
        sl = slice(i, i + chunk)
        err = max(err, _close(torch, f"{name} dequantized",
                              ref.dequantize_blocks_plain(pg[sl], ng[sl], levels, bits=bits),
                              ref.dequantize_blocks_plain(pw[sl], nw[sl], levels, bits=bits)))
    return err


def _plain_chunks(torch, fn, rows, chunk=1 << 18):
    """Run a plain version in row chunks (its intermediates at the full
    buffer would not fit beside the buffers): ``fn(row slice)`` per chunk,
    outputs concatenated along rows."""
    parts = [fn(slice(i, min(i + chunk, rows))) for i in range(0, rows, chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def kernel_times(torch, launches: dict, errs: dict, shapes: list, int_ops: float,
                 qada: dict) -> list:
    """Each kernel at the shape the main path gives it: the tinyllama-1.1b
    flat exchange buffer (K = 1, bucket 512, q = inf); kernels 1-3 as the
    int8 two_phase exchange runs them (kernel 2 and 3 on kernel 1's and
    kernel 2's outputs), kernels 1 and 4 as the int4 gather exchange runs
    them, kernel 5 as ``compress_tree`` runs it on that buffer (qgenx int8:
    one table; layerwise: the plan's two segments).  The device-PRNG
    variants of kernels 1, 2 and 5 run on the same inputs right after the
    host-noise kernel (kernel 2's on the device-PRNG kernel 1's payload),
    their plain versions (``philox_uniform``'s draw, then the host-noise
    plain version) in row chunks.  Each kernel's last timed output is held
    against its plain version's on the same inputs (payload bytes and
    kernel 5's estimates exactly equal, f32 within rtol 1e-6);
    ``max_abs_err`` is the larger of this and phase 3's.  ``launches`` is
    each kernel's count over the main path it runs on; ``int_ops`` the
    device draw's integer operations per coordinate.  Kernels 1 (int8) and 2
    run again on phase 4d's QAda table (``qada``), timed the same way,
    their ``launches`` phase 4d's."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import uniform_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_reduce import (
        dequant_reduce_blocks,
        dequant_reduce_requantize_blocks,
    )
    from repro_torch.kernels.dequantize import dequantize_blocks
    from repro_torch.kernels.quantize import quantize_blocks

    dev = torch.device("cuda")
    bucket = 512
    n_live = exchanged_coords(get_config("tinyllama-1.1b"))
    rows = -(-n_live // bucket)
    n = rows * bucket
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    out = []

    def entry(name, bits, ms, plain_ms, err, nbytes, ops, what=None, iops=0, runs=None):
        kernel = kernel_key(name)
        out.append(kernel_row(name, launches[kernel] if runs is None else runs, ms, plain_ms,
                              max(err, errs[kernel]), nbytes, ops,
                              f"{rows} x {bucket}, {what or f'int{bits}'}", int_ops=iops))

    def draw(seed, sl):
        return ref.philox_uniform(seed, sl.start, sl.stop - sl.start, bucket, dev)

    def quantize(bits, s, lv):
        """Kernel 1 with host noise, then with the device PRNG, on one x."""
        kw = dict(num_symbols=s + 2, q_is_inf=True, bits=bits)
        x = torch.randn((rows, bucket), generator=gen, device=dev)
        r = torch.rand((rows, bucket), generator=gen, device=dev)
        ms, got = _time_ms(torch, lambda: quantize_blocks(x, r, lv, **kw), 10)
        plain, want = _time_ms(torch, lambda: ref.quantize_blocks_plain(x, r, lv, **kw), 2)
        del r
        torch.cuda.empty_cache()
        err = _deq_err(torch, f"quantize int{bits} main-path shape", got, want, lv, bits)
        del want
        entry(f"quantize_blocks/int{bits}", bits, ms, plain, err,
              4 * n + 4 * n + n * bits // 8 + 4 * rows, n * (10 + 2 * s))
        ms, got_p = _time_ms(torch, lambda: quantize_blocks(x, None, lv, seed=PRNG_SEED,
                                                            **kw), 10)
        plain, want = _time_ms(torch, lambda: _plain_chunks(
            torch, lambda sl: ref.quantize_blocks_plain(x[sl], draw(PRNG_SEED, sl), lv, **kw),
            rows), 1)
        del x
        torch.cuda.empty_cache()
        err = _deq_err(torch, f"quantize/prng int{bits} main-path shape", got_p, want, lv,
                       bits)
        del want
        entry(f"quantize_blocks/prng/int{bits}", bits, ms, plain, err,
              4 * n + n * bits // 8 + 4 * rows, n * (10 + 2 * s), iops=n * int_ops)
        return got, got_p

    # int8 two_phase (s = 15): kernel 1 -> kernel 2 -> kernel 3
    s, bits = 15, 8
    lv = uniform_levels(s, dev)
    (payload, norms), prng_out = quantize(bits, s, lv)
    P, N = payload.unsqueeze(0), norms.unsqueeze(0)
    r2 = torch.rand((rows, bucket), generator=gen, device=dev)  # the re-quantize draw
    ms, got = _time_ms(torch, lambda: dequant_reduce_requantize_blocks(
        P, N, lv, r2, num_symbols=s + 2, num_workers=1, q_is_inf=True, bits=bits), 10)
    plain, want = _time_ms(torch, lambda: ref.dequant_reduce_requantize_blocks_plain(
        P, N, lv, r2, num_symbols=s + 2, q_is_inf=True, bits=bits), 2)
    del r2, P, N, payload, norms
    torch.cuda.empty_cache()
    err = _deq_err(torch, "dequant_reduce_requantize main-path shape", got, want, lv, bits)
    entry("dequant_reduce_requantize_blocks", bits, ms, plain, err,
          n + 4 * rows + 4 * n + n + 4 * rows, n * (14 + 2 * s))
    del want
    # the device-PRNG kernel 2 on the device-PRNG kernel 1's payload, its
    # own seed (an exchange's second draw)
    P, N = prng_out[0].unsqueeze(0), prng_out[1].unsqueeze(0)
    kw = dict(num_symbols=s + 2, q_is_inf=True, bits=bits)
    ms, got_p = _time_ms(torch, lambda: dequant_reduce_requantize_blocks(
        P, N, lv, None, num_workers=1, seed=PRNG_SEED + 1, **kw), 10)
    plain_p, want = _time_ms(torch, lambda: _plain_chunks(
        torch, lambda sl: ref.dequant_reduce_requantize_blocks_plain(
            P[:, sl], N[:, sl], lv, draw(PRNG_SEED + 1, sl), **kw), rows), 1)
    del P, N, prng_out
    torch.cuda.empty_cache()
    err = _deq_err(torch, "dequant_reduce_requantize/prng main-path shape", got_p, want, lv,
                   bits)
    entry("dequant_reduce_requantize_blocks/prng", bits, ms, plain_p, err,
          n + 4 * rows + n + 4 * rows, n * (14 + 2 * s), iops=n * int_ops)
    del want, got_p
    payload, norms = got
    ms, got = _time_ms(torch, lambda: dequantize_blocks(
        payload, norms, lv, num_symbols=s + 2, bits=bits), 10)
    plain, want = _time_ms(torch, lambda: ref.dequantize_blocks_plain(
        payload, norms, lv, bits=bits), 2)
    err = _close(torch, "dequantize main-path shape", got, want)
    entry("dequantize_blocks", bits, ms, plain, err, n + 4 * rows + 4 * n, 3 * n)
    del payload, norms, got, want
    torch.cuda.empty_cache()

    # kernels 1 and 2 on phase 4d's QAda table (its bracket search)
    lv = qada["levels"]
    kw = dict(num_symbols=s + 2, q_is_inf=True, bits=bits)
    x = torch.randn((rows, bucket), generator=gen, device=dev)
    r = torch.rand((rows, bucket), generator=gen, device=dev)
    what = f"int8, phase 4d's QAda table ({qada['branch']})"
    ms, got = _time_ms(torch, lambda: quantize_blocks(x, r, lv, **kw), 10)
    plain, want = _time_ms(torch, lambda: ref.quantize_blocks_plain(x, r, lv, **kw), 2)
    del x
    torch.cuda.empty_cache()
    err = _deq_err(torch, "quantize int8 QAda table main-path shape", got, want, lv, bits)
    del want
    entry("quantize_blocks/int8-qada", bits, ms, plain, err,
          4 * n + 4 * n + n + 4 * rows, n * (10 + 2 * s), what=what,
          runs=qada["counts"]["quantize_blocks"])
    P, N = got[0].unsqueeze(0), got[1].unsqueeze(0)
    del got
    ms, got = _time_ms(torch, lambda: dequant_reduce_requantize_blocks(
        P, N, lv, r, num_workers=1, **kw), 10)
    plain, want = _time_ms(torch, lambda: ref.dequant_reduce_requantize_blocks_plain(
        P, N, lv, r, **kw), 2)
    del r, P, N
    torch.cuda.empty_cache()
    err = _deq_err(torch, "dequant_reduce_requantize QAda table main-path shape", got, want,
                   lv, bits)
    entry("dequant_reduce_requantize_blocks/qada", bits, ms, plain, err,
          n + 4 * rows + 4 * n + n + 4 * rows, n * (14 + 2 * s), what=what,
          runs=qada["counts"]["dequant_reduce_requantize_blocks"])
    del got, want
    torch.cuda.empty_cache()

    # int4 gather (s = 5): kernel 1 -> kernel 4
    s, bits = 5, 4
    lv = uniform_levels(s, dev)
    (payload, norms), _ = quantize(bits, s, lv)
    P, N = payload.unsqueeze(0), norms.unsqueeze(0)
    ms, got = _time_ms(torch, lambda: dequant_reduce_blocks(
        P, N, lv, num_symbols=s + 2, num_workers=1, bits=bits), 10)
    plain, want = _time_ms(torch, lambda: ref.dequant_reduce_blocks_plain(
        P, N, lv, bits=bits), 2)
    err = _close(torch, "dequant_reduce main-path shape", got, want)
    entry("dequant_reduce_blocks", bits, ms, plain, err, n // 2 + 4 * rows + 4 * n, 4 * n)
    del P, N, payload, norms, got, want
    torch.cuda.empty_cache()
    segment_times(torch, gen, rows, bucket, shapes, entry, int_ops)
    return out


def segment_times(torch, gen, rows, bucket, shapes, entry, int_ops) -> None:
    """Kernel 5 on the tinyllama-1.1b compress buffer, with the qgenx int8
    table (T = 1) and with the layerwise plan's two segments (T = 2: leaves
    above 65536 coordinates in int4 first, the rest in int8), each with
    host noise and with the device PRNG, each in two windows of 10 calls
    (the second is the row's time).  The plain version runs in row
    chunks; its chunks are timed together and each is held bit-equal to
    the kernel's rows."""
    from repro_torch.core.exchange import ExchangeConfig, make_exchange
    from repro_torch.core.exchange_plan import stack_level_tables
    from repro_torch.core.quantization import QuantConfig, uniform_levels
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_quantize import quantize_dequantize_segments

    dev = torch.device("cuda")
    lo = QuantConfig(num_levels=5, bits=4, bucket_size=bucket)
    plan = make_exchange(ExchangeConfig(compressor="layerwise", quant=lo)).plan_for(
        shapes, "compress", 1)
    seg_rows = [seg.padded // bucket for seg in plan.segments]
    if sum(seg_rows) != rows or [s.quant.bits for s in plan.segments] != [4, 8]:
        fail(f"layerwise plan {plan.describe()} does not cover the {rows}-row buffer")
    n = rows * bucket
    x = torch.randn((rows, bucket), generator=gen, device=dev)
    r = torch.rand((rows, bucket), generator=gen, device=dev)
    variants = [
        ("qgenx-int8", [uniform_levels(15, dev)],
         torch.zeros((rows,), dtype=torch.int32, device=dev)),
        ("layerwise", [uniform_levels(5, dev), uniform_levels(15, dev)],
         torch.cat([torch.full((k,), t, dtype=torch.int32, device=dev)
                    for t, k in enumerate(seg_rows)])),
    ]
    for tag, tables, seg in variants:
        stacked, ns = stack_level_tables(tables)
        kw = dict(num_symbols=ns, q_is_inf=True, stochastic=True)
        for prng in (False, True):
            name = "quantize_dequantize_segments" + ("/prng" if prng else "")
            seed = PRNG_SEED if prng else None
            def call():
                return quantize_dequantize_segments(x, None if prng else r, stacked, seg,
                                                    seed=seed, **kw)

            # two windows: the first after the buffers' allocation reads up to
            # 0.9 ms slower with host noise; the second is the kernel's time
            first, _ = _time_ms(torch, call, 10)
            ms, got = _time_ms(torch, call, 10)
            log(f"  {name} {tag}: first window {first:.4f} ms, second {ms:.4f} ms")

            def plain_chunk(sl):
                noise = (ref.philox_uniform(PRNG_SEED, sl.start, sl.stop - sl.start, bucket,
                                            dev) if prng else r[sl])
                return ref.quantize_dequantize_segments_plain(x[sl], noise, stacked, seg[sl],
                                                              **kw)

            plain, want = _time_ms(torch, lambda: _plain_chunks(torch, plain_chunk, rows), 1)
            if not torch.equal(got, want):
                fail(f"{name} {tag} main-path shape: {int((got != want).sum())} estimates "
                     "differ from the plain version")
            del got, want
            torch.cuda.empty_cache()
            # x (and the host noise) read once, the estimate written once;
            # per coordinate: abs, divide, clamp, (s_max - 2) compares, two
            # subtracts, a divide, the rounding compare, sign and product
            entry(f"{name}/tinyllama-buffer-{tag}", 0, ms, plain, 0.0,
                  (8 if prng else 12) * n + 4 * rows + 4 * stacked.numel(), n * (10 + max(ns)),
                  what=f"T={len(tables)} ns={ns}; no path runs kernel 5 at this size",
                  iops=n * int_ops if prng else 0, runs=0)


def phase_start(torch, name: str) -> float:
    """Free what earlier phases dropped and log the device memory they
    still hold (every peak a later phase reports includes it); returns the
    phase's start time."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase {name}: {torch.cuda.memory_allocated()} bytes of device memory allocated "
        f"at its start")
    return time.perf_counter()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--skip-train", action="store_true",
                    help="debugging: phases 1-3 only (prints no result)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    from repro_torch.kernels import cuda

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    lib = cuda.build()
    cuda.library()
    log(f"phase 2: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    log("  kernels 1, 2 and 5 (one warp per row):")
    row_kernel_resources(cuda.build_log())
    int_ops = philox_int_ops(torch)
    log(f"  device draw: {int_ops} integer operations per coordinate")

    # phase 3: kernel parity on the card
    t0 = time.perf_counter()
    errs = kernel_parity(torch)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    if args.skip_train:
        log("--skip-train: stopping after phase 3")
        sys.exit(4)

    # phase 4a: the LM path at full width, then card vs cpu at small size
    t0 = time.perf_counter()
    shapes = tinyllama_leaf_shapes(torch)
    by_run = train_path(torch, args.batch, args.seq, shapes)
    card_vs_cpu(torch)
    log(f"phase 4a took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(r["counts"][k] for r in by_run.values()) for k in cuda.KERNELS}

    # phase 4c: sync_every with the drift probe, recenter_every, coded_bits_est,
    # the wire recorder and a checkpoint resume, at full width
    t0 = phase_start(torch, "4c")
    for k, n in local_update_path(torch, args.batch, args.seq).items():
        launches[k] += n
    log(f"phase 4c took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4d: QAda adaptive levels on the main-path exchange, at full width
    t0 = phase_start(torch, "4d")
    qada = qada_path(torch, args.batch, args.seq, shapes, by_run["int8"])
    for k, n in qada["counts"].items():
        launches[k] += n
    log(f"phase 4d took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4f: the sparse compressors (ef21-topk, randk) at full width
    t0 = phase_start(torch, "4f")
    sparse_counts, sparse_peaks = sparse_path(torch, args.batch, args.seq, shapes,
                                              by_run["int8"])
    for k, n in sparse_counts.items():
        launches[k] += n
    log(f"phase 4f took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4g: the step guard, fault injection and the watchdog's rollback, at full width
    t0 = phase_start(torch, "4g")
    guard = guard_path(torch, args.batch, args.seq, by_run["int8"], sparse_peaks["ef21-topk"])
    for k, n in guard["counts"].items():
        launches[k] += n
    log(f"phase 4g took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4b: the WGAN-GP testbed, every arm, and uq8 with the device PRNG
    t0 = phase_start(torch, "4b")
    gan, gan_rows = gan_path(torch, int_ops)
    launches["quantize_dequantize_segments"] = sum(
        n for arm, (_, n) in gan.items() if arm != GAN_PRNG_ARM)
    launches["quantize_dequantize_segments/prng"] = gan[GAN_PRNG_ARM][1]
    log(f"phase 4b took {time.perf_counter() - t0:.1f} s")

    # phase 4e: the toy-VI testbed (Fig. 4 and the compression arms) over kernel 5
    t0 = phase_start(torch, "4e")
    toy_launches, toy_row = toy_vi_path(torch)
    launches["quantize_dequantize_segments"] += toy_launches
    log(f"phase 4e took {time.perf_counter() - t0:.1f} s")

    # phase 4h: the serving path at full width, and kernels 1 and 3 at its shapes
    t0 = phase_start(torch, "4h")
    serve = serve_path(torch)
    serve_rows = serve_kernel_rows(torch, serve, errs)
    log(f"phase 4h took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4i: gemma-2b, qwen3-4b and gemma3-27b on the train and serve paths
    t0 = phase_start(torch, "4i")
    arch_train = archs_train(torch, args.batch, args.seq)
    arch_serve = archs_serve(torch)
    arch_rows = archs_kernel_rows(torch, arch_train, arch_serve, errs)
    log(f"phase 4i took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4j: the exchange's layouts (bucketed, defer_tail, per-call, leafwise)
    t0 = phase_start(torch, "4j")
    layouts = layouts_path(torch, args.batch, args.seq, shapes, by_run["int8"])
    for k, n in layouts["total"].items():
        launches[k] += n
    log(f"phase 4j took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4k: llama4's MoE and internvl2's prefix embeds on the train and serve paths
    t0 = phase_start(torch, "4k")
    families = families_path(torch, args.batch, args.seq, by_run["int8"])
    log(f"phase 4k took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 5: kernel times at the main-path shapes
    t0 = phase_start(torch, "5")
    rows = (kernel_times(torch, launches, errs, shapes, int_ops, qada) + gan_rows + [toy_row]
            + serve_rows + arch_rows + leafwise_kernel_rows(torch, shapes, layouts, errs)
            + families_kernel_rows(torch, families, errs))
    log(f"phase 5 took {time.perf_counter() - t0:.1f} s")

    print(card, flush=True)  # again, beside the results (a log's tail keeps it)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
