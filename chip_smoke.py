"""End-to-end smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases (any failure exits non-zero):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: csrc/day_scan.cu, csrc/flash_attention.cu,
     csrc/flash_attention_bwd.cu, csrc/ssd_scan.cu and csrc/ssd_scan_bwd.cu
     with nvcc (sm_90a) from the checkout, and csrc/day_scan.cu once more
     with its probe modes (-DDAY_SCAN_PROBE), one nvcc each, all at once;
     the ptxas lines (registers, spills) of the day scan and the
     backward kernels;
  3. kernel vs its plain PyTorch version on the card, on the serving
     grid's day tables (N = 64 combos, T = 4320 steps, L = 3 levels) and
     on ragged N = 63 and N = 200: all nine outputs bit for bit equal;
     the full-trace mode at N = 64, 63 and 1 on the same tables: all 17
     outputs bit for bit equal to `day_scan_plain(full=True)`, its first
     nine equal to the default mode's;
  4. main path: `DesignTwin()` on the default grid at dt_s = 10 s (warm
     query, a repeat, then three what-ifs: another policy's thresholds,
     another battery, a single platform), each checked against the
     reference's golden answers in src/repro_torch/data/
     (front_mask / survives() / shutdown exactly, objectives rtol
     1e-5); the day-scan kernel must launch exactly once per query;
     then the twin's other paths, each driven with the launch count set
     to 0 just before it and read just after:
     a. batched golden: `what_if_many` over the golden's four queries,
        each report against the golden and bit for bit equal to its
        serial answer; one launch per signature group;
     b. K = 16 what-ifs of the thermal governor's temp_trip_c on the full
        default grid through `query_batch`: one launch at N = 1024 (16 x
        64 combos), each answer bit for bit equal to its serial query,
        and the kernel bit for bit equal to its plain version on the
        batch's own tables (all nine outputs);
     c. `submit` / `run` from 4 threads (2 submit point what-ifs, 1
        submits grid what-ifs, 1 drains), mixed signatures: every result
        bit for bit equal to its serial answer, one launch per batch
        signature group;
     d. the legacy engine, `dse.day_pareto(engine="legacy")` on the
        default grid: one launch, front / survives() / shutdown equal to
        the fused engine's, trace extrema equal, sums within rtol 1e-5;
        a repeat is served by the row cache (no row evaluated again);
        the kernel against its plain version on the engine's tables;
     e. `simulate_users` for 64 users (8 battery fades x 8 ambient
        offsets) of one combo: one launch at N = 64, survives() /
        shutdown / day hours equal to the same call on the CPU, traces
        within rtol 1e-6 / atol 1e-4, sums within rtol 1e-5; the kernel
        against its plain version on the call's tables;
     f. `simulate` (examples/all_day.py's rayban_cam desk_day day, and a
        throttled aria2_puck_split field_day): each one full-trace launch
        at N = 1; level / shut / th_state / soc_state equal to the same
        call on the CPU, the other traces within rtol 1e-6 / atol 1e-4,
        the summary within rtol 1e-6; the kernel against its plain version
        on the call's tables, all 17 outputs;
     g. the steady-state layer (no kernel): the 2304-point
        `dse.joint_pareto` on the card against the CPU (front_mask equal,
        objectives within rtol 1e-6, `co_optimize` rows equal), and the
        rows of `placement_sweep`, `compression_sweep`, `pareto` and
        `platform_ablation` equal to the CPU's;
     h. the gradient co-design path (examples/gradient_codesign.py's
        calls): a. `dse.sensitivity_map("aria2")` on the 768-point grid
        against the CPU (totals rtol 1e-6, every d_mw_d leaf rtol 1e-5 /
        atol 1e-3 mW) and the relaxed engine bit for bit equal to
        `evaluate` at the grid's binary rows; b. the 540-step relaxed day
        (aria2_display / offload_lean / field_day / battery_saver, dt_s =
        60) and its gradient w.r.t. the policy point against the CPU
        (tte_h / throttled_frac equal, soft_tte_h rtol 1e-5, gradients
        rtol GRAD_RTOL with equal signs, d / d soc_trip positive), its
        tte_h and throttled_frac equal to `simulate`'s (one full-trace
        launch), at an exactly binary placement its t_skin / soc traces
        within the trace tolerance of `simulate`'s, and its integrator on
        `simulate`'s own tables bit for bit equal to the kernel (all 17
        outputs); c. `dse.optimize_policy` on that day, 4
        restarts, Adam steps cut from the example's 60 to 8: one
        full-trace launch for the baseline and one per restart, each held
        to its plain version (17 outputs), the returned policy's level /
        shut / time-to-empty equal on the CPU; d. `calibrate.fit_ensemble`
        (6 restarts x 150 steps) against the CPU from the same starts
        (losses rtol 1e-3, the same best restart) and `fit_queue_coeff`
        (rtol 1e-4);
     i. the fleet layer on `DEFAULT_POPULATION` (4 archetypes, 9
        timezones, 4 streams, L = 3, T = 720 at dt_s 60), every day-scan
        launch held to its plain version at once (17 outputs, bit for
        bit, days >= 1 with their initial SoC): a. `fleet_day` for 4096
        users, one launch a chunk and day, against the same call on the
        CPU (survives() / shutdown / time-to-empty equal, peak skin and
        end SoC within 1e-6, curves and pod-hours within rtol 1e-6; the
        card's row stage puts some archetype-table entries an ulp off
        the CPU's), and on the CPU's archetype tables every per-user
        output equal to the CPU's; b. the
        example's 100 000 users (fleet_size 1e6): launches = chunks, peak
        device memory, a repeat bit-equal, the first 4096 users run alone
        equal, the curve's integral equal to the scaled pod-hours within
        1e-6; c. a 256-user week (7 days) undercharged (a 50 mW dock, days
        1-6 start below a full battery) against the CPU as in a, and fully
        recharged against the single day (curve within 1e-6); d.
        `reference_fleet` against `fleet_day` on 24 users with mixed
        survival (every per-user output equal); e. `autoscale.simulate`: `INSTANT` provisions the
        curve's integral and drops nothing, the default spec within rtol
        1e-6 of the CPU; f. `montecarlo.fleet_distribution` (256 users x 8
        draws, dt_s 120, autoscaled) against the CPU (survival draws and
        TTE equal, arrays within 1e-6), `reuse_prep` True and False
        bit-identical; g. `dse.fleet_pareto()` (9 variants x 1024 users)
        with and without an autoscaler: front_mask equal to the CPU's,
        rows within rtol 1e-6;
  5. timing: day-scan kernel ms (CUDA events over many launches) at
     N = 64, 1 and 1024 (16 grids folded into N), the full-trace mode's
     at N = 64 and 1 beside its bound, the default mode's chain floor
     (probe mode "no loads or stores") beside the bound, the SM clock
     under the kernel, the plain version's ms, warm query and what-if
     ms, a profile of warm queries, batched ms per item at K = 1, 4 and
     16 (warm, host clock ending in a copy to the host) beside the warm
     serial query, row-stage passes per batch and a profile of one
     K = 16 batch; the joint front's ms (host clock) and a profile of
     one call; the gradient path: ms per Adam step of 4 h c (host
     clock) and a profile of one step, `simulate` ms, the example's
     60-step `optimize_policy` estimated from them, ms per
     `fit_ensemble` step, `sensitivity_map` ms; the fleet layer:
     `fleet_day` warm ms at 4096 and 100 000 users (host clock, ending in
     the copy to the host), the full-trace kernel's ms at a fleet launch
     (N = 4096 and a 16 384-user chunk, CUDA events) beside its bound, a
     profile of one 4096-user call, Monte Carlo draws/s,
     `autoscale.simulate` ms and kernels a call, `fleet_pareto` ms;
  6. flash-attention and SSD-scan kernels vs their plain versions on the
     card: at the zamba2-1.2b prefill shapes in bf16 and float32, flash
     at a GQA 4:1 + window 96 + ragged-S case at Dh = 128; SSD at the
     prefill shape with dt as the reference tests draw it and with dt x
     0.05 (slow decay, so the state carried between the kernel's groups
     counts in y), at a ragged s and at g = 2 (n = 128).  Flash: atol =
     rtol = 2e-5 in float32 (tests/test_kernels.py), atol 8e-3 / rtol
     2^-7 (one bf16 spacing) in bf16; and in bf16 at the prefill shape,
     against the plain version on the kernel's own tiles
     (`flash_attention.TILES`), a relative RMS error under
     FLASH_ROUNDING_LIMIT, which the same plain version with p left
     unrounded (v in float32) must exceed.  SSD: tests/test_kernels.py's
     atol max(tol, 1e-4), rtol 5 tol (tol 2e-5 float32, 2e-2 bf16); in
     bf16 also a relative RMS error under SSD_BF16_LIMIT, which the plain
     version with x dt and W rounded to bf16 must exceed; and the split's
     float32 group states (`ssd_group_states_cuda`, the bf16 path's
     split-bf16 tensor-core products) against `ssd_split_states_plain` at
     the float32 tolerance;
  7. main path: the zamba2-1.2b prefill step (`make_prefill_step`) at
     full width and depth (38 layers, bf16 weights and compute, seeded
     numpy weights) on B = 2 prompts of S = 4096 tokens; one call must
     launch flash exactly 6 times and the SSD kernels exactly 3 x 38
     times (`ssd_scan.kernel_launches`: state, pass and scan launches a
     call), with finite last hidden and logits;
  8. golden: the port's float32 prefill at full width, 8 layers, against
     src/repro_torch/data/golden_zamba2.json (written from the JAX
     reference): weight checksum equal, logits at the sampled and top-8
     ids within 5e-5 x the spread of the non-top-1 logits, the top-8
     ranks equal up to ties; the same run in bf16 must miss that
     tolerance (the top-1 is the row's own token under the tied
     embedding, so it checks nothing);
  9. the Server at full width and depth in float32: 3 requests of 32-64
     token prompts, 16 new tokens each, 2 slots; every request gets its
     tokens, its first token is the argmax of the float32 prefill step's
     logits on its left-padded prompt and every later one the argmax of
     the float32 forward over the prompt and the tokens before it; the
     same tokens teacher-forced through `decode_step` give the forward's
     logits at every position within DEC_ATOL_REL x their spread, which
     the bf16 forward must miss;
 10. timing: flash and SSD kernel ms (CUDA events), plain ms, bounds,
     `scaled_dot_product_attention` ms at the flash shape (a yardstick
     only: the port never calls it), the SSD split's scratch traffic,
     prefill ms and tokens/s, Server decode ms per token, peak device
     memory, a profile of one prefill.

The transformer family (weights from a seeded CPU torch.Generator,
moved to the card, except the golden's seeded numpy weights):

 11. flash vs its plain version at the new head widths, float32 and bf16,
     with phase 6's tolerances: gemma3-4b's global and local layers (B =
     2, S = 4096, H 8 / KvH 4, Dh 256, no window / window 1024),
     phi-3-vision's (H 32, Dh 96) and two ragged S (1100 at Dh 256 with
     the window, 1000 at Dh 96); the bf16 rounding control at the causal
     full-length shapes;
 12. main path: gemma3-4b's prefill step at full width and depth (34
     layers, bf16) on B = 2 prompts of S = 4096: flash launched exactly 34
     times, 29 with window 1024 and 5 without, all bf16 at Dh 256; last
     hidden, KV cache and logits finite;
 13. golden: the float32 prefill at full width, 6 layers (five local, one
     global), B = 1, S = 1152, against src/repro_torch/data/
     golden_gemma3.json (written from the JAX reference by
     tests/torch_golden_gemma3.py): weights checksum equal, logits at the
     sampled and top-8 ids within 5e-5 x the non-top-1 spread but for
     each row's top-1, which is held to 1e-5 of itself, top-8 ranks equal
     up to ties; the bf16 run must miss;
 14. the Server at full width and depth in float32 (gemma3-4b), as phase
     9: tokens against the float32 forward's argmax, teacher-forced
     decode logits within DEC_ATOL_REL x the spread, the bf16 forward
     outside it;
 15. phi-3-vision-4.2b at full width and depth: a bf16 prefill (B = 2, S
     = 4096, 576 seeded vision embeddings), 32 flash launches at Dh 96
     without a window, finite outputs;
 16. olmo-1b, granite-3-2b, yi-34b, moonshot-v1-16b-a3b and dbrx-132b at
     full width, depth cut to 2 layers (yi-34b whole is ~68 GB in bf16,
     dbrx-132b ~264 GB): a bf16 prefill (B = 1, S = 4096) through the
     kernel (2 launches) and again through `flash_attention_plain`
     (none), every layer's attention output within ATTN_RMS_LIMIT and
     the last hidden within HIDDEN_RMS_LIMIT relative RMS; for the two
     MoE archs `moe_apply` against `moe_apply_dense` on layer 0 (bf16
     within MOE_RMS_LIMIT, float32 within 1e-5) and the card's expert
     ids equal to the CPU's up to ties;
 17. timing: bf16 flash ms at gemma3's global and local shapes and
     phi-3's beside the plain version's, `scaled_dot_product_attention`'s
     (and the kernel that served it) and the bound; gemma3-4b prefill ms,
     tokens/s and peak device memory, Server decode ms per token, a
     profile of one prefill.

The training path and whisper-medium:

 18. the flash backward kernel (through the autograd function: the
     forward kernel with its row lse, then the backward kernel) against
     autograd of `flash_attention_plain`, float32 and bf16, at olmo-1b's
     training shape (B = 2, S = 2048, H 16, Dh 128, causal), whisper's
     encoder (1500 x 1500, Dh 64, bidirectional) and cross-attention (Sq
     448, Sk 1500), gemma3-4b's global and local layers (H 8 / KvH 4, Dh
     256, window 1024), phi-3-vision's (Dh 96) and zamba2-1.2b's shared
     block at phase 24's step (B = 4, S = 2048, H 32, Dh 64, causal):
     float32 within BWD_F32_REL of each gradient's largest magnitude,
     bf16 within BWD_BF16_MAX of it and BWD_BF16_RMS relative RMS of the
     plain version's bf16 run, whose distance to the float32 gradients
     must exceed BWD_F32_REL; at every shape and dtype a second run
     through the autograd function bit for bit equal to the first;
 19. main path: olmo-1b at full width and depth (16 layers, float32
     parameters, bf16 compute), B = 4 x S = 2048: the first step through
     the kernels (16 forward + 16 backward launches, every gradient
     finite, wq / wk / wv of every layer nonzero) against the same step
     through the plain attention (loss and grad norm within
     TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL); `launch.train.train` for 6
     AdamW steps with a checkpoint (under build/, removed after), the
     checkpoint restored bit for bit, `train` resumed from it for 2 more
     steps, then one step with int8 gradient compression: every loss and
     grad norm finite, 16 + 16 flash launches every step;
 20. olmo-1b at full width, 2 layers, float32, B = 1 x S = 512: one
     `make_train_step` (remat) on the card and on the CPU from the same
     numpy weights: loss, per-leaf gradients and updated parameters within
     the stated tolerances;
 21. whisper-medium at full width: a bf16 prefill at full depth (24 + 24
     layers, B = 2, 448 decoder tokens, 1500 frames), 72 flash launches
     (24 bidirectional, 24 causal, 24 cross); its float32 golden at 4 + 4
     layers (src/repro_torch/data/golden_whisper.json, written by
     tests/torch_golden_whisper.py) held as gemma3-4b's is, with a bf16
     control; 3 float32 decode steps on a prefilled cache against the
     teacher-forced forward (DEC_ATOL_REL x the spread, the bf16 forward
     outside it); one 2 + 2-layer train step through the kernels against
     the plain attention (6 + 6 launches);
 22. timing: the backward kernel's ms at each phase 18 shape (bf16)
     beside `flash_attention_bwd_plain`'s, scaled_dot_product_attention's
     backward (a yardstick only) and the bound (2.5 x the forward's
     products over the peak, or the bytes over HBM bandwidth); olmo-1b's
     ms per step, tokens/s, share of the bf16 peak and peak memory; a
     profile of one `make_train_step`.

The SSD family's training path:

 23. a. every family's `init` (transformer, MoE, VLM, hybrid, SSM,
     encdec smoke configs) from one CPU-generator seed bit-equal on the
     card and the CPU, and `train.side_inputs` (encdec, VLM) likewise;
     b. the SSD forward's serving launch and the launch that keeps its
     group states (what `SSDScan` runs) give the same y bit for bit, at
     zamba2's and mamba2-2.7b's prefill shapes; c. the SSD backward
     kernel (through `ssd_scan`'s autograd route) against
     `ssd_scan_bwd_plain` at zamba2's (b 2, s 4096, h 64, n 64) and
     mamba2-2.7b's (h 80, n 128) shapes, a ragged s, one group (no
     split) and g = 2: float32 within SSD_BWD_F32_REL of each gradient's
     largest magnitude, bf16 within SSD_BWD_BF16_RMS relative RMS, which
     the plain version with W and G o E rounded to bf16 must exceed;
     a second run bit-equal;
 24. main path: zamba2-1.2b at full width and depth (38 mamba layers, 6
     shared-block calls, f32 parameters, bf16 compute), B = 4 x S =
     2048: the first step through the kernels (114 SSD forward launches,
     38 backward calls, 6 + 6 flash, every gradient finite and A_log /
     dt_bias / in_proj / conv_w / out_proj nonzero in every layer)
     against the same step through the plain SSD and attention (loss and
     grad norm within TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL);
     `launch.train.train` for 6 AdamW steps with a checkpoint restored
     bit for bit, the same launches every step, the losses finite and
     moving;
 25. zamba2-1.2b at full width, 2 layers, float32, B = 1 x S = 512: one
     `make_train_step` on the card and on the CPU from the same numpy
     weights, held as phase 20; mamba2-2.7b at full width, 4 of 64
     layers: one bf16-compute step through the kernels against the plain
     SSD;
 26. timing: the SSD backward's ptxas lines (registers and spills of
     every entry; a spill in a bf16 launch is a miss); its ms at
     zamba2's and mamba2-2.7b's prefill shapes and phase 24's, beside
     `ssd_scan_bwd_plain`'s and the bound (no library call computes the
     SSD gradient); zamba2-1.2b's ms per step, tokens/s, share of the
     bf16 peak (`ssm_train_flops`) and peak memory; a profile of one
     `make_train_step`, with the SSD backward's busy ms in it and each
     of its launches' mean device time.

The transformer family's Dh 256 training path:

 27. main path: gemma3-4b at full width, depth cut to 12 of 34 layers (10
     local with window 1024, 2 global), float32 parameters, bf16 compute,
     B = 4 x S = 2048: the first step through the kernels (12 forward +
     12 backward launches, every gradient finite, wq / wk / wv of every
     layer nonzero) against the same step through the plain attention
     (loss and grad norm within TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL); 3
     steps of `launch.train.train` (12 + 12 launches each): ms per step,
     tokens/s, share of the bf16 peak (`train_flops`, each layer's window
     counted), peak memory; a profile of one `make_train_step` with the
     backward kernel's busy ms.

mamba2-2.7b's tuned config (SSD chunk 128), the perception nets and the
launch tools:

 28. a. the SSD forward at mamba2-2.7b's prefill shape (B = 2 x S =
        4096, h 80, n 128) asked for at chunk 128: against
        `ssd_scan_plain(chunk=128)` with phase 6's tolerances and bf16
        control, its launches equal to a chunk-64 call's and y bit-equal
        to it (the kernels run their own 64-row tile); its ms at chunk 64
        and 128 in turns; the backward against
        `ssd_scan_bwd_plain(chunk=128)` with phase 23 c's tolerances;
     b. main path: `mamba2_2p7b.tuned()` at full width and depth (64
        layers), bf16 prefill B = 2 x S = 4096 through
        `launch.steps.make_prefill_step`: 192 SSD launches, tokens/s,
        share of the bf16 peak (`ssm_prefill_flops`), peak memory, a
        profile;
     c. its 4-layer float32 golden (`golden_mamba2.json`, chunk 128) as
        phase 8, with the bf16 control;
     d. the Server in float32 at full depth, as phase 9: decode ms per
        token at B = 2;
     e. a train step at 4 of 64 layers through `SSDScan` at chunk 128
        against the plain SSD at chunk 128, as phase 25 b;
 29. the six perception nets (`perception/nets.py`) at the frozen FLOP
     table's shapes on the card against their CPU runs on the same seeded
     weights, TF32 off (the Conformer's float32 run against the CPU's
     float64 run, with a TF32 control that must miss): ms per call,
     `torch_flops()` beside XLA's count;
 30. the measured-cell harness: `launch.dryrun.run_cell` on mamba2-2.7b
     tuned x prefill_32k and olmo-1b x train_4k (each at its batch cut)
     into a temporary directory, each artifact's step ms, peak memory,
     counted FLOPs against the analytical compute term and
     `roofline_fraction`, then `roofline_grid` over the directory (each
     measured row at its own batch beside the full-batch analytical
     terms).

Nothing earlier is cut for time.

The second-to-last lines are the `kernels` JSON object (the day scan's
launches summed over the serial, batched, legacy, simulate_users,
simulate, gradient and fleet paths of phase 4, both modes; its
max_abs_err covers phase 3 and the tables of 4 b, d, e, f, h and i;
flash's launches summed over phases 7, 12, 15, 16, 19-21, 24, 27 and
30, its max_abs_err over phases 6 and 11; the backward's launches over
phases 19-21, 24, 27 and 30, its max_abs_err over phase 18, its times at
olmo-1b's shape; the SSD scan's launches over phases 7, 24, 25, 28 and
30, its max_abs_err over phases 6 and 28 a; the SSD backward's calls
over phases 24-25 and 28 e, its max_abs_err over phases 23 c and 28 a,
its times at zamba2's prefill shape) and the nvidia-smi line; the last line
is the result object.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12          # H100 SXM float32, outside tensor cores
# float ops of one combo-step of the day scan (daysim._step_math; an exp
# or a division counted as one op)
OPS_PER_STEP = 104
OBJ_RTOL = 1e-5                 # objectives vs the golden (sums of traces)
# legacy engine (float64 sums on the host) vs the fused engine (float32
# sums on the card): the reference's tolerance (tests/test_twin.py)
SUM_RTOL = SUM_ATOL = 1e-5
# trace values (end SoC, peak skin) of the card against the CPU: the
# reference's tolerance for the day scan (tests/test_kernels.py)
TRACE_RTOL, TRACE_ATOL = 1e-6, 1e-4
# the report fields a batched answer must share bit for bit with its serial
# one (tests/test_twin_serving.py's _FIELDS)
REPORT_FIELDS = ("time_to_empty_h", "peak_skin_c", "pod_hours", "end_soc",
                 "energy_mwh", "throttled_h", "steady_mw", "day_hours")
PEAK_BF16_OPS_S = 989e12        # H100 SXM bf16 tensor cores, dense
PEAK_OPS_S = {"bfloat16": PEAK_BF16_OPS_S, "float32": PEAK_F32_OPS_S}
LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
# bf16 flash vs plain: twice the reading at the prefill shape (0.0039),
# plus one bf16 spacing of the value
FLASH_BF16_ATOL, FLASH_BF16_RTOL = 8e-3, 2.0 ** -7
# relative RMS error of the bf16 flash kernel against the plain version on
# its own tiles (float32 sum order only; 2.4e-5 on an H100) vs the
# p-unrounded control (2.1e-3)
FLASH_ROUNDING_LIMIT = 5e-4
# relative RMS error of the bf16 SSD kernel against the plain version:
# 2.0e-5 to 6.6e-5 read on an H100 (sum order and the bf16 rounding of y
# it flips), against 2.9e-3 to 3.4e-3 for the plain version with x dt and
# W rounded to bf16 before their product (a tensor-core shortcut)
SSD_BF16_LIMIT = 5e-4
# decode_step vs the float32 forward's logits, relative to their spread
# (~40): 2.5e-5 read on an H100, 2.2e-1 for the bf16 forward
DEC_ATOL_REL = 1e-4
LM_SEED = 0                     # seeded numpy weights of the prefill/Server
B_PREFILL, S_PREFILL = 2, 4096  # S = Zamba2-1.2B's max_position_embeddings


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


MISSES: list = []   # tolerance checks missed; the run fails at its end


def miss(msg: str) -> None:
    """A result outside its tolerance: reported now, and the run goes on
    to read the other checks before it fails."""
    print(f"chip_smoke: MISSED: {msg}", file=sys.stderr)
    MISSES.append(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(log: str) -> list:
    """`flash_kernel_<dtype><Dh> N registers, spills` for each flash
    instantiation in an nvcc -Xptxas -v log (`flash_bwd_<launch><dtype,
    Dh>` for the backward's, `ssd_bwd_<launch><dtype, n>` for the SSD
    backward's)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function .*?(flash_kernel_[a-z0-9]+)ILi(\d+)E",
                      line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"entry function .*?(flash_bwd_[a-z]+)I(13__nv_"
                      r"bfloat16|f)(?:Li(\d+))?E", line)
        if m:
            dtype = "bf16" if m.group(2) != "f" else "f32"
            name = f"{m.group(1)}<{dtype}{', ' + m.group(3) if m.group(3) else ''}>"
        m = re.search(r"entry function .*?(flash_bwd_hb)ILi(\d+)E", line)
        if m:                           # the bf16 tensor-core launch
            name = f"{m.group(1)}<bf16, {m.group(2)}>"
        m = re.search(r"entry function .*?(ssd_bwd_[a-z0-9_]+?)I(13__nv_"
                      r"bfloat16|f)?Li(\d+)E", line)
        if m:                           # the SSD backward's launches
            dtype = {None: "", "f": "f32, "}.get(m.group(2), "bf16, ")
            name = f"{m.group(1)}<{dtype}{m.group(3)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spills {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} registers, {spill}")
            name = None
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of `fn()` over `reps` back-to-back calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel: dict, plain: dict) -> float:
    """Kernel vs plain outputs: all of them (nine, or the full trace's
    17) bit for bit equal (the kernel keeps every operation of the plain
    version and its order); returns the largest absolute difference,
    0."""
    import torch
    if tuple(kernel) != tuple(plain):
        fail(f"day_scan kernel outputs {tuple(kernel)} != the plain "
             f"version's {tuple(plain)}")
    for k in plain:
        if kernel[k].dtype != plain[k].dtype or not torch.equal(kernel[k],
                                                                plain[k]):
            err = float((kernel[k].double() - plain[k].double()).abs().max())
            fail(f"day_scan kernel {k} differs from the plain version (max "
                 f"abs diff {err})")
    return max(float((kernel[k].double() - plain[k].double()).abs().max())
               for k in plain)


def sm_clocks(fn, seconds: float) -> tuple:
    """(clocks.sm, clocks.max.sm) in MHz as nvidia-smi reads them while
    the card runs `fn` back to back for about `seconds`."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-5)
    for _ in range(max(1, int(seconds / one))):
        fn()                        # queued; nvidia-smi reads meanwhile
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    torch.cuda.synchronize()
    if out.returncode != 0:
        fail(f"nvidia-smi clocks: {out.stderr.strip()}")
    sm, top = out.stdout.strip().splitlines()[0].split(",")
    return sm.strip(), top.strip()


def resize(tables: dict, n: int) -> dict:
    """Day tables cut or tiled to `n` combos along N; tiled copies get
    their ambient shifted by 0.5 K per copy so they differ."""
    import torch
    n0 = tables["step_mw"].shape[-1]
    idx = torch.arange(n, device=tables["step_mw"].device) % n0
    shift = (torch.arange(n, device=idx.device) // n0).float() * 0.5
    out = {k: v[..., idx].contiguous() for k, v in tables.items()
           if k != "const"}
    out["ambient"] = out["ambient"] + shift
    out["const"] = {k: v[idx].contiguous()
                    for k, v in tables["const"].items()}
    return out


def bound_ms(n: int, t: int, n_lvl: int, n_out: int = 9) -> tuple:
    """(bound ms, "bytes" | "operations") of one day-scan call with
    `n_out` (T, N) outputs (9, or the full trace's 17): the bytes it
    must move (each input read once — one throttle level of each table
    per step — and each output written once) over HBM bandwidth vs its
    float ops over the float32 peak."""
    f32 = 4
    read = (3 * t * n + 5 * t * n + n_lvl * n + 31 * n) * f32
    write = n_out * t * n * f32
    by_bytes = (read + write) / PEAK_BYTES_S * 1e3
    by_ops = n * t * OPS_PER_STEP / PEAK_F32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def profile_queries(run, reps: int, label: str = "warm query") -> tuple:
    """Device time of `reps` calls of `run` (a warm query) by kernel,
    from torch.profiler: the device-busy ms per call, the day-scan
    kernel's share and the number of kernels launched per call; returns
    (report, day-scan ms per call or None)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((dev_us / reps, e.count / reps, e.key))
    if not rows:
        return ("profile: the profiler saw no device time (not measured)",
                None)
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    scan_us = sum(r[0] for r in rows if "day_scan" in r[2])
    top = "; ".join(f"{k[:48]} {us / 1e3:.3f} ms x{c:g}"
                    for us, c, k in rows[:5])
    return (f"profile (per {label}, {reps} calls): device busy "
            f"{busy_us / 1e3:.3f} ms in {sum(r[1] for r in rows):g} "
            f"kernels, day_scan {scan_us / 1e3:.3f} ms; top: {top}",
            scan_us / 1e3)


def check_golden(name: str, rep, want: dict) -> None:
    import numpy as np
    if rep.combos != want["combos"]:
        fail(f"{name}: combo labels differ from the golden")
    for k, got in (("front_mask", rep.front_mask),
                   ("survives", rep.survives()),
                   ("shutdown", rep.shutdown)):
        if not np.array_equal(np.asarray(got, bool),
                              np.asarray(want[k], bool)):
            fail(f"{name}: {k} differs from the golden")
    for k in ("time_to_empty_h", "peak_skin_c", "pod_hours"):
        if not np.allclose(getattr(rep, k), np.asarray(want[k]),
                           rtol=OBJ_RTOL, atol=0.0):
            fail(f"{name}: {k} outside rtol {OBJ_RTOL} of the golden")


def golden_overrides(spec: dict, daysim) -> dict:
    import dataclasses
    out = dict(spec)
    if "policy" in out:
        p = dict(out["policy"])
        out["policy"] = dataclasses.replace(daysim.get_policy(p.pop("base")),
                                            **p)
    if "battery" in out:
        out["battery"] = daysim.BatterySpec.from_dict(out["battery"])
    return out


def identical(name: str, got, want) -> None:
    """A batched answer against its serial one: the same combos, front
    and survival flags, and every field of REPORT_FIELDS bit for bit."""
    import numpy as np
    if got.combos != want.combos:
        fail(f"{name}: combo labels differ from the serial answer")
    pairs = [("front_mask", got.front_mask, want.front_mask),
             ("survives", got.survives(), want.survives())]
    pairs += [(f, getattr(got, f), getattr(want, f)) for f in REPORT_FIELDS]
    for k, a, b in pairs:
        if not np.array_equal(a, b):
            diff = float(np.max(np.abs(np.asarray(a, float)
                                       - np.asarray(b, float))))
            fail(f"{name}: {k} differs from the serial answer (max abs "
                 f"diff {diff})")


def governor_grids(daysim, k: int, start: int = 0) -> list:
    """k default-grid queries, each with the thermal governor's
    temp_trip_c moved (value-level what-ifs of one signature, as
    tests/test_twin_serving.py's _policies)."""
    import dataclasses
    gov = daysim.get_policy("thermal_governor")
    return [{"policies": ("none", dataclasses.replace(
                gov, name=f"v{start + i}",
                temp_trip_c=38.0 + 0.1 * (start + i)), "battery_saver")}
            for i in range(k)]


def point_whatifs(daysim, k: int, start: int = 0) -> list:
    """k one-combo what-ifs (tests/test_twin_serving.py's
    _point_whatifs)."""
    import dataclasses
    gov = daysim.get_policy("thermal_governor")
    return [{"platform": "aria2_display",
             "design": daysim.DEFAULT_DESIGNS[1], "schedule": "commuter",
             "policy": dataclasses.replace(
                 gov, name=f"t{start + i}",
                 temp_trip_c=38.0 + 0.05 * (start + i))}
            for i in range(k)]


@contextlib.contextmanager
def scan_calls(ds):
    """Record the tables and outputs of every day-scan call made
    inside, so the kernel can be held to its plain version on the very
    inputs the main path gave it."""
    calls, real = [], ds.day_scan

    def recording(tables, full=False):
        ys = real(tables, full)
        calls.append((tables, ys))
        return ys

    ds.day_scan = recording
    try:
        yield calls
    finally:
        ds.day_scan = real


def held_to_plain(name: str, calls: list) -> float:
    """Each recorded day-scan call against the plain version on its own
    tables in the call's mode, all outputs bit for bit; returns the
    largest abs error (these plain launches are not the main path's)."""
    import torch
    from repro_torch.kernels import day_scan as ds
    worst = 0.0
    for tables, ys in calls:
        want = ds.day_scan_plain(tables, full=len(ys) > len(ds.OUTS))
        torch.cuda.synchronize()
        worst = max(worst, compare(ys, want))
    print(f"{name}: kernel == plain on the main path's own tables at N = "
          f"{[int(t['step_mw'].shape[-1]) for t, _ in calls]}, all "
          f"{[len(ys) for _, ys in calls]} outputs bit for bit")
    return worst


# The golden's four queries fall into three bucketed shape signatures:
# the base grid and the battery what-if share one (value-level change),
# the one-policy and the one-platform grids have N_b 32 and rows of
# their own.
GOLDEN_GROUPS = 3


def twin_paths(twin, golden: dict, serial: dict, dt_s: float) -> tuple:
    """Phase 4 a-e: the batched golden, the K = 16 batch, submit / run
    from threads, the legacy engine and simulate_users; returns the
    day-scan launches of those paths (each read just after its own run)
    and the kernel's largest error against its plain version on the
    tables of the K = 16 batch, the legacy engine and simulate_users."""
    import numpy as np
    from repro_torch.core import daysim, dse
    from repro_torch.kernels import day_scan as ds
    launches, worst_err = 0, 0.0

    # a. the golden's four queries in one what_if_many
    names = list(golden["queries"])
    whatifs = [golden_overrides(golden["queries"][n]["overrides"], daysim)
               for n in names]
    batches = twin.stats.batches
    ds.LAUNCHES = 0
    reps = twin.what_if_many(whatifs)
    n = ds.LAUNCHES
    launches += n
    if n != GOLDEN_GROUPS or twin.stats.batches - batches != GOLDEN_GROUPS:
        fail(f"batched golden: {n} launches, "
             f"{twin.stats.batches - batches} batches for {GOLDEN_GROUPS} "
             f"signature groups")
    for name, rep in zip(names, reps):
        check_golden(f"batched {name}", rep, golden["queries"][name])
        identical(f"batched {name}", rep, serial[name])
    print(f"main path (batched golden): what_if_many over {len(names)} "
          f"queries in {GOLDEN_GROUPS} signature groups, {n} launches; each "
          f"matches the golden and equals its serial answer bit for bit")

    # b. K = 16 value-level what-ifs on the full default grid
    queries = governor_grids(daysim, 16)
    want = [twin.query(**q) for q in queries]
    with scan_calls(ds) as calls:
        ds.LAUNCHES = 0
        got = twin.query_batch(queries)
        n = ds.LAUNCHES
    launches += n
    widths = [int(t["step_mw"].shape[-1]) for t, _ in calls]
    if n != 1 or widths != [1024]:
        fail(f"K = 16 batch: {n} launches at N = {widths}, want one at "
             f"N = 1024")
    for i, (g, w) in enumerate(zip(got, want)):
        identical(f"K = 16 batch query {i}", g, w)
    print(f"main path (K = 16 batch, default grid): 1 launch at N = "
          f"{widths[0]}; all 16 answers equal their serial queries bit for "
          f"bit (fronts {[int(r.front_mask.sum()) for r in got]})")
    worst_err = max(worst_err, held_to_plain("K = 16 batch", calls))
    del calls

    # c. submit / run from 4 threads, mixed signatures
    points = point_whatifs(daysim, 6, 300)
    grids = governor_grids(daysim, 4, 300)
    want = {f"p{i}": twin.what_if(**w) for i, w in enumerate(points)}
    want.update({f"g{i}": twin.query(**q) for i, q in enumerate(grids)})
    qid_to_key, results, errors = {}, {}, []
    key_lock = threading.Lock()

    def submit(items, tag):
        for i, w in items:
            qid = twin.submit(**w)
            with key_lock:
                qid_to_key[qid] = f"{tag}{i}"

    def drain():
        try:
            for wi in twin.run():
                results[wi.qid] = wi.report
        except Exception as e:                  # noqa: BLE001
            errors.append(repr(e))

    batches = twin.stats.batches
    ds.LAUNCHES = 0
    threads = [threading.Thread(target=submit,
                                args=(list(enumerate(points))[:3], "p")),
               threading.Thread(target=submit,
                                args=(list(enumerate(points))[3:], "p")),
               threading.Thread(target=submit,
                                args=(list(enumerate(grids)), "g")),
               threading.Thread(target=drain)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            fail("submit / run: a thread did not finish in 600 s")
    results.update({wi.qid: wi.report for wi in twin.run()})
    n = ds.LAUNCHES
    launches += n
    if errors:
        fail(f"submit / run: {errors}")
    if len(results) != len(qid_to_key) or len(results) != 10:
        fail(f"submit / run: {len(results)} results for "
             f"{len(qid_to_key)} submissions")
    if n != twin.stats.batches - batches:
        fail(f"submit / run: {n} launches for "
             f"{twin.stats.batches - batches} signature-group batches")
    for qid, key in qid_to_key.items():
        identical(f"submit / run {key}", results[qid], want[key])
    print(f"main path (submit / run, 4 threads): 10 what-ifs (6 one-combo, "
          f"4 grids) in {twin.stats.batches - batches} signature-group "
          f"batches, {n} launches; every result equals its serial answer "
          f"bit for bit")

    # d. the legacy engine against the fused one
    fused = serial["base"]
    with scan_calls(ds) as calls:
        ds.LAUNCHES = 0
        legacy = dse.day_pareto(engine="legacy", dt_s=dt_s)
        n = ds.LAUNCHES
    rows = dict(daysim.CACHE_STATS)
    ds.LAUNCHES = 0
    again = dse.day_pareto(engine="legacy", dt_s=dt_s)
    n_again = ds.LAUNCHES
    launches += n + n_again
    if n != 1 or n_again != 1:
        fail(f"legacy engine: {n} and {n_again} launches, want 1 each")
    stats = daysim.CACHE_STATS
    if stats["evaluate_calls"] != rows["evaluate_calls"] \
            or stats["misses"] != rows["misses"] \
            or stats["hits"] <= rows["hits"]:
        fail(f"legacy engine: the repeat missed the row cache ({rows} -> "
             f"{stats})")
    if legacy.combos != fused.combos:
        fail("legacy engine: combo labels differ from the fused engine's")
    for k, a, b in (("front_mask", legacy.front_mask, fused.front_mask),
                    ("survives", legacy.survives(), fused.survives()),
                    ("shutdown", legacy.shutdown, fused.shutdown),
                    *((f, getattr(legacy, f), getattr(fused, f))
                      for f in ("end_soc", "peak_skin_c", "steady_mw",
                                "day_hours"))):
        if not np.array_equal(a, b):
            fail(f"legacy engine: {k} differs from the fused engine's")
    worst = 0.0
    for k in ("time_to_empty_h", "pod_hours", "energy_mwh", "throttled_h"):
        a, b = getattr(legacy, k), getattr(fused, k)
        worst = max(worst, float(np.max(np.abs(a - b)
                                        / np.maximum(np.abs(b), 1e-30))))
        if not np.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL):
            miss(f"legacy engine: {k} outside rtol {SUM_RTOL} of the fused "
                 f"engine's")
        if not np.array_equal(getattr(again, k), a):
            fail(f"legacy engine: the repeat changed {k}")
    print(f"main path (legacy engine, default grid): 1 launch at N = "
          f"{len(legacy)}; front / survives / shutdown and trace extrema "
          f"equal to the fused engine's, sums within {worst:.3g} relative "
          f"(rtol {SUM_RTOL:g}); the repeat hit the row cache "
          f"({stats['hits'] - rows['hits']} rows, 0 evaluated)")
    worst_err = max(worst_err, held_to_plain("legacy engine", calls))
    del calls

    # e. simulate_users: 64 users (battery fade x ambient offset) of one
    # combo, on the card and on the CPU; on this combo the hotter half
    # of the users hit the thermal hard-kill
    fades = np.repeat(np.linspace(0.0, 0.35, 8), 8)
    offsets = np.tile(np.linspace(-6.0, 8.0, 8), 8)
    args = ("aria2_display", daysim.DEFAULT_DESIGNS[2], "field_day",
            "thermal_governor")
    kw = dict(fades=fades, ambient_offsets_c=offsets, dt_s=dt_s)
    with scan_calls(ds) as calls:
        ds.LAUNCHES = 0
        users = daysim.simulate_users(*args, **kw)
        n = ds.LAUNCHES
    launches += n
    widths = [int(t["step_mw"].shape[-1]) for t, _ in calls]
    if n != 1 or widths != [len(fades)]:
        fail(f"simulate_users: {n} launches at N = {widths}, want one at "
             f"N = {len(fades)}")
    cpu = daysim.simulate_users(*args, **kw, device="cpu")
    if users.combos != cpu.combos:
        fail("simulate_users: user labels differ from the CPU run's")
    for k, a, b in (("survives", users.survives(), cpu.survives()),
                    ("shutdown", users.shutdown, cpu.shutdown),
                    ("day_hours", users.day_hours, cpu.day_hours)):
        if not np.array_equal(a, b):
            fail(f"simulate_users: {k} differs from the CPU run's")
    for k, rtol, atol in (("end_soc", TRACE_RTOL, TRACE_ATOL),
                          ("peak_skin_c", TRACE_RTOL, TRACE_ATOL),
                          ("steady_mw", TRACE_RTOL, 0.0),
                          *((f, SUM_RTOL, SUM_ATOL)
                            for f in ("time_to_empty_h", "pod_hours",
                                      "energy_mwh", "throttled_h"))):
        if not np.allclose(getattr(users, k), getattr(cpu, k), rtol=rtol,
                           atol=atol):
            miss(f"simulate_users: {k} outside rtol {rtol} of the CPU "
                 f"run's")
    print(f"main path (simulate_users, {len(fades)} users): 1 launch at "
          f"N = {len(fades)}; survive {int(users.survives().sum())}, "
          f"shutdown {int(users.shutdown.sum())}; equal to the CPU run on "
          f"discrete outputs, traces within rtol {TRACE_RTOL:g}, sums within "
          f"rtol {SUM_RTOL:g}")
    worst_err = max(worst_err, held_to_plain("simulate_users", calls))
    return launches, worst_err


# phase 4 f's days: (platform, DEFAULT_DESIGNS index, schedule, policy)
SIMULATE_DAYS = (("rayban_cam", 0, "desk_day", "battery_saver"),
                 ("aria2_puck_split", 1, "field_day", "thermal_governor"))
DISCRETE_TRACES = ("level", "shut", "th_state", "soc_state", "valid")
CONTINUOUS_TRACES = ("soc", "soc_puck", "t_soc_c", "t_skin_c",
                     "t_skin_puck_c", "p_mw", "p_puck_mw", "drain_mw",
                     "drain_puck_mw", "pods")
# objectives of the joint front, card vs CPU: the reference's rtol for
# scenario totals (tests/test_platform_api.py)
TOTAL_RTOL = 1e-6
CO_BUDGETS = ({}, {"pod_budget": 40.0}, {"power_budget_mw": 1100.0},
              {"usd_budget_per_day": 3.0e5})


def simulate_days(dt_s: float) -> tuple:
    """Phase 4 f: `simulate` on the card against the same call on the
    CPU; returns (launches, full-trace launches, the kernel's largest
    error against its plain version on the calls' own tables)."""
    import numpy as np
    from repro_torch.core import daysim
    from repro_torch.kernels import day_scan as ds
    launches = full_launches = 0
    worst = 0.0
    for plat, design, schedule, policy in SIMULATE_DAYS:
        args = (plat, daysim.DEFAULT_DESIGNS[design], schedule, policy)
        name = f"simulate {plat}/{schedule}/{policy}"
        with scan_calls(ds) as calls:
            ds.LAUNCHES = ds.FULL_LAUNCHES = 0
            got = daysim.simulate(*args, dt_s=dt_s)
            n, n_full = ds.LAUNCHES, ds.FULL_LAUNCHES
        launches += n
        full_launches += n_full
        widths = [int(t["step_mw"].shape[-1]) for t, _ in calls]
        if (n, n_full) != (1, 1) or widths != [1]:
            fail(f"{name}: {n} launches ({n_full} full-trace) at N = "
                 f"{widths}, want one full-trace launch at N = 1")
        want = daysim.simulate(*args, dt_s=dt_s, device="cpu")
        for k in DISCRETE_TRACES:
            if not np.array_equal(getattr(got, k), getattr(want, k)):
                fail(f"{name}: {k} differs from the CPU run's")
        err = 0.0
        for k in CONTINUOUS_TRACES:
            a, b = getattr(got, k), getattr(want, k)
            err = max(err, float(np.max(np.abs(a - b))))
            if not np.allclose(a, b, rtol=TRACE_RTOL, atol=TRACE_ATOL):
                miss(f"{name}: {k} outside rtol {TRACE_RTOL} / atol "
                     f"{TRACE_ATOL} of the CPU run's")
        if list(got.summary) != list(want.summary):
            fail(f"{name}: summary keys differ from the CPU run's")
        for k, v in want.summary.items():
            if not np.isclose(got.summary[k], v, rtol=TOTAL_RTOL, atol=0.0):
                miss(f"{name}: summary {k} {got.summary[k]} outside rtol "
                     f"{TOTAL_RTOL} of the CPU run's {v}")
        print(f"main path ({name}, dt_s = {dt_s:g}): 1 full-trace launch "
              f"at N = 1, T = {len(got.level)}; level / shut / th_state / "
              f"soc_state equal to the CPU run (throttled steps "
              f"{int((got.level > 0).sum())}, thermal latch "
              f"{int(got.th_state.sum())}, SoC latch "
              f"{int(got.soc_state.sum())}), traces max abs diff "
              f"{err:.3g}; tte {got.summary['time_to_empty_h']:.3f} h")
        worst = max(worst, held_to_plain(name, calls))
    return launches, full_launches, worst


def steady_state_paths() -> None:
    """Phase 4 g: the steady-state layer on the card against the CPU."""
    import numpy as np
    from repro_torch.core import dse
    got = dse.joint_pareto()
    want = dse.joint_pareto(device="cpu")
    if len(got) != 2304:
        fail(f"joint_pareto: {len(got)} points, want 2304")
    if not np.array_equal(got.front_mask, want.front_mask):
        fail(f"joint_pareto: the front on the card ({int(got.front_mask.sum())}"
             f" points) differs from the CPU's ({int(want.front_mask.sum())})")
    objs, ref = got.objectives(), want.objectives()
    rel = float(np.max(np.abs(objs - ref) / np.maximum(np.abs(ref), 1e-30)))
    if not np.allclose(objs, ref, rtol=TOTAL_RTOL, atol=0.0):
        miss(f"joint_pareto: objectives {rel:.3g} relative off the CPU's "
             f"(rtol {TOTAL_RTOL:g})")
    for budgets in CO_BUDGETS:
        if dse.co_optimize(got, **budgets) != dse.co_optimize(want,
                                                             **budgets):
            fail(f"co_optimize {budgets}: rows differ from the CPU's")
    for name, fn in (("placement_sweep", dse.placement_sweep),
                     ("compression_sweep", dse.compression_sweep),
                     ("pareto", dse.pareto),
                     ("platform_ablation", dse.platform_ablation)):
        if fn() != fn(device="cpu"):
            fail(f"{name}: rows on the card differ from the CPU's")
    print(f"steady state (joint_pareto, {len(got)} points): front "
          f"{int(got.front_mask.sum())} equal to the CPU's, objectives "
          f"within {rel:.3g} relative ({int((got.device_mw != want.device_mw).sum())}"
          f" device_mw values not bit-equal), co_optimize rows equal "
          f"under {len(CO_BUDGETS)} budgets; placement_sweep, "
          f"compression_sweep, pareto and platform_ablation rows equal")


# phase 4 h: examples/gradient_codesign.py's calls (platform, DEFAULT_DESIGNS
# index, schedule, policy) at its dt_s; the example's 60 Adam steps of
# optimize_policy are cut to GRAD_STEPS to bound the phase's time
GRAD_DAY = ("aria2_display", 0, "field_day", "battery_saver")
GRAD_DT = 60.0
GRAD_RESTARTS, GRAD_STEPS, EXAMPLE_STEPS = 4, 8, 60
ENSEMBLE = (6, 150)             # the example's fit_ensemble(n_restarts, steps)
# sensitivity rows, card vs CPU (a zero row's gradient to 1e-3 mW)
SENS_RTOL, SENS_ATOL = 1e-5, 1e-3
# relaxed-day gradients w.r.t. the policy point, card vs CPU: 2.5e-7
# relative read in the first card run on an H100, held at 40x that
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
# calibration losses (the reference's vmapped-vs-sequential tolerance)
# and the queue coefficient, card vs CPU
CAL_RTOL, QUEUE_RTOL = 1e-3, 1e-4
BINARY_LOGIT = 200.0            # sigmoid(-200) == 0.0 exactly in float32


def sensitivity_check() -> None:
    """Phase 4 h a: the 768-point sensitivity map on the card against
    the CPU, and the relaxed engine bit for bit equal to the hard one at
    the grid's binary rows on the card."""
    import numpy as np
    import torch
    from repro_torch.core import dse, scenarios
    got = dse.sensitivity_map("aria2")
    want = dse.sensitivity_map("aria2", device="cpu")
    if len(got["sset"]) != 768:
        fail(f"sensitivity_map: {len(got['sset'])} points, want 768")
    rel = float(np.max(np.abs(got["total_mw"] - want["total_mw"])
                       / np.abs(want["total_mw"])))
    if not np.allclose(got["total_mw"], want["total_mw"], rtol=TOTAL_RTOL,
                       atol=0.0):
        miss(f"sensitivity_map: total_mw {rel:.3g} relative off the CPU's")
    worst = 0.0
    for k, w in want["d_mw_d"].items():
        g = got["d_mw_d"][k]
        worst = max(worst, float(np.max(np.abs(g - w) / np.maximum(
            np.abs(w), SENS_ATOL / SENS_RTOL))))
        if not np.allclose(g, w, rtol=SENS_RTOL, atol=SENS_ATOL):
            miss(f"sensitivity_map: d_mw_d[{k}] outside rtol {SENS_RTOL} / "
                 f"atol {SENS_ATOL} of the CPU's")
    plat = dse._plat("aria2")
    rep = scenarios.evaluate(plat, got["sset"])
    out = scenarios.evaluate_relaxed(plat, scenarios.relax_vec(got["sset"]))
    for k, hard in (("total", rep.total_mw), ("loads", rep.loads_mw),
                    ("mbps", rep.offloaded_mbps),
                    ("pd_loss", rep.pd_loss_mw)):
        if not torch.equal(out[k], hard):
            fail(f"relaxed engine {k} differs from evaluate's at binary "
                 f"rows on the card")
    print(f"gradient path a (sensitivity_map, 768 points): totals within "
          f"{rel:.3g} relative of the CPU's, every d_mw_d leaf within "
          f"{worst:.3g} relative; relaxed == evaluate bit for bit on the "
          f"768 binary rows (loads, totals, Mbps, PD loss)")


def relaxed_day_check(ds) -> tuple:
    """Phase 4 h b: the 540-step relaxed day and its gradient w.r.t. the
    policy point on the card against the CPU, and against `simulate` on
    the card (one full-trace launch); returns (launches, the kernel's
    largest error against its plain version)."""
    import numpy as np
    import torch
    from repro_torch.core import daysim, design
    plat, d, sched, pol = GRAD_DAY
    row = daysim.DEFAULT_DESIGNS[d]
    outs, grads, binary = {}, {}, None
    for dev in ("cuda", "cpu"):
        f = daysim.relaxed_day_fn(plat, sched, pol, row, dt_s=GRAD_DT,
                                  device=dev)
        pt = {k: v.requires_grad_() for k, v in design.policy_point(
            daysim.get_policy(pol), dev).items()}
        outs[dev] = f(pt)
        grads[dev] = np.asarray([float(g) for g in torch.autograd.grad(
            outs[dev]["soft_tte_h"], list(pt.values()))])
        if dev == "cuda":
            binary = f({**{k: v.detach() for k, v in pt.items()},
                        "placement_logits": torch.full(
                            (4,), -BINARY_LOGIT, device=dev)})
    names = list(design.policy_space().names())
    with scan_calls(ds) as calls:
        ds.LAUNCHES = ds.FULL_LAUNCHES = 0
        tr = daysim.simulate(plat, row, sched, pol, dt_s=GRAD_DT)
        n, n_full = ds.LAUNCHES, ds.FULL_LAUNCHES
    if (n, n_full) != (1, 1):
        fail(f"relaxed day's simulate: {n} launches ({n_full} full trace)")
    card = {k: v.detach().cpu().numpy() for k, v in outs["cuda"].items()}
    cpu = {k: v.detach().cpu().numpy() for k, v in outs["cpu"].items()}
    if len(card["t_skin"]) != 540:
        fail(f"relaxed day: {len(card['t_skin'])} steps, want 540")
    tte = tr.summary["time_to_empty_h"]
    if abs(float(card["tte_h"]) - tte) > 1e-6:
        fail(f"relaxed day: tte_h {float(card['tte_h'])} != simulate's {tte}")
    thr = float(np.mean(tr.level > 0))
    if abs(float(card["throttled_frac"]) - thr) > 1e-7:
        fail(f"relaxed day: throttled_frac {float(card['throttled_frac'])} "
             f"!= simulate's {thr}")
    # at a binary placement the relaxed tables are the hard ones up to
    # the row sums' order (the relaxed engine sums its 12 rows in one
    # pass, simulate's row cache its own batch): traces at the trace
    # tolerance; the eager integrator on simulate's own tables is the
    # kernel, bit for bit
    bin_err = 0.0
    for k, want in (("t_skin", tr.t_skin_c), ("soc", tr.soc)):
        got = binary[k].detach().cpu().numpy()
        bin_err = max(bin_err, float(np.max(np.abs(got - want))))
        if not np.allclose(got, want, rtol=TRACE_RTOL, atol=TRACE_ATOL):
            miss(f"relaxed day at a binary placement: {k} outside rtol "
                 f"{TRACE_RTOL} / atol {TRACE_ATOL} of simulate's")
    (tables, ys), = calls
    one = {k: v[..., 0] for k, v in tables.items() if k != "const"}
    one["const"] = {k: v[0] for k, v in tables["const"].items()}
    eager = daysim._integrate_one(one)
    for k in ds.TRACE_OUTS:
        if not torch.equal(eager[k], ys[k][0]):
            fail(f"relaxed day's integrator on simulate's tables: {k} "
                 f"differs from the kernel's")
    for k in ("tte_h", "throttled_frac"):
        if card[k] != cpu[k]:
            fail(f"relaxed day: {k} on the card differs from the CPU's")
    soft_rel = abs(float(card["soft_tte_h"]) - float(cpu["soft_tte_h"])) \
        / abs(float(cpu["soft_tte_h"]))
    if soft_rel > 1e-5:
        miss(f"relaxed day: soft_tte_h {soft_rel:.3g} relative off the CPU's")
    g_card, g_cpu = grads["cuda"], grads["cpu"]
    g_rel = float(np.max(np.abs(g_card - g_cpu)
                         / np.maximum(np.abs(g_cpu), GRAD_ATOL)))
    if not np.allclose(g_card, g_cpu, rtol=GRAD_RTOL, atol=GRAD_ATOL):
        miss(f"relaxed day: gradient {dict(zip(names, g_card))} outside "
             f"rtol {GRAD_RTOL} of the CPU's {dict(zip(names, g_cpu))}")
    live = np.abs(g_cpu) > GRAD_ATOL
    if not np.array_equal(np.sign(g_card[live]), np.sign(g_cpu[live])):
        fail("relaxed day: a gradient's sign differs from the CPU's")
    if not g_card[names.index("soc_trip")] > 0.0:
        fail("relaxed day: d soft_tte_h / d soc_trip is not positive")
    worst = held_to_plain("relaxed day's simulate", calls)
    print(f"gradient path b (relaxed_day_fn {plat}/{sched}/{pol}, dt_s = "
          f"{GRAD_DT:g}, 540 steps): tte_h {float(card['tte_h']):.4f} and "
          f"throttled_frac {float(card['throttled_frac']):.6f} equal to "
          f"simulate's and the CPU's; at a binary placement t_skin / soc "
          f"within {bin_err:.3g} of simulate's; the eager integrator on "
          f"simulate's tables == the kernel on all 17 outputs; soft_tte_h "
          f"{float(card['soft_tte_h']):.6f} ({soft_rel:.3g} relative off "
          f"the CPU); d soft_tte_h / d point "
          + ", ".join(f"{k} {g:+.6g}" for k, g in zip(names, g_card))
          + f" ({g_rel:.3g} relative off the CPU, signs equal)")
    return n, worst


def optimize_policy_check(ds) -> tuple:
    """Phase 4 h c: the example's `optimize_policy` on the card (Adam
    steps cut to GRAD_STEPS): one full-trace launch for the baseline and
    one per hardened restart, each held to its plain version; the
    returned policy re-simulated on the CPU.  Returns (launches, the
    kernel's largest error, the call's wall s, the result)."""
    import numpy as np
    import torch
    from repro_torch.core import daysim, dse
    plat, d, sched, pol = GRAD_DAY
    row = daysim.DEFAULT_DESIGNS[d]
    with scan_calls(ds) as calls:
        ds.LAUNCHES = ds.FULL_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt = dse.optimize_policy(plat, row, sched, pol,
                                  n_restarts=GRAD_RESTARTS,
                                  steps=GRAD_STEPS, dt_s=GRAD_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, n_full = ds.LAUNCHES, ds.FULL_LAUNCHES
    if (n, n_full) != (1 + GRAD_RESTARTS, 1 + GRAD_RESTARTS):
        fail(f"optimize_policy: {n} launches ({n_full} full trace), want "
             f"{1 + GRAD_RESTARTS} full-trace launches")
    worst = held_to_plain("optimize_policy", calls)
    # the returned policy on the CPU against the card (a check launch)
    args = (plat, row, sched, opt["policy"])
    cpu = daysim.simulate(*args, dt_s=GRAD_DT, device="cpu")
    card = daysim.simulate(*args, dt_s=GRAD_DT)
    for k in ("level", "shut"):
        if not np.array_equal(getattr(card, k), getattr(cpu, k)):
            fail(f"optimize_policy: the returned policy's {k} on the CPU "
                 f"differs from the card's")
    tte = cpu.summary["time_to_empty_h"]
    if not tte == card.summary["time_to_empty_h"] == opt["tte_h"]:
        fail(f"optimize_policy: time_to_empty_h {opt['tte_h']} (card) vs "
             f"{tte} (CPU)")
    b = opt["baseline"]
    print(f"gradient path c (optimize_policy {plat}/{sched}/{pol}, "
          f"{GRAD_RESTARTS} restarts x {GRAD_STEPS} Adam steps, dt_s = "
          f"{GRAD_DT:g}): {n} full-trace launches, each == plain (17 "
          f"outputs); grid policy tte {b['tte_h']:.3f} h peak "
          f"{b['peak_skin_c']:.3f} C -> trips T={opt['policy'].temp_trip_c:.2f}"
          f" C SoC={opt['policy'].soc_trip:.3f}, tte {opt['tte_h']:.3f} h "
          f"peak {opt['peak_skin_c']:.3f} C (gain {opt['gain_h']:+.3f} h, "
          f"feasible {opt['feasible']}); level / shut / tte equal on the "
          f"CPU; {wall:.2f} s wall")
    return n, worst, wall, opt


def calibration_check() -> None:
    """Phase 4 h d: the example's `fit_ensemble` and `fit_queue_coeff`
    on the card against the CPU, from the same start points."""
    import numpy as np
    from repro_torch.core import calibrate
    r, steps = ENSEMBLE
    got = calibrate.fit_ensemble(n_restarts=r, steps=steps)
    want = calibrate.fit_ensemble(n_restarts=r, steps=steps, device="cpu")
    rel = float(np.max(np.abs(got["losses"] - want["losses"])
                       / np.abs(want["losses"])))
    if not np.allclose(got["losses"], want["losses"], rtol=CAL_RTOL):
        miss(f"fit_ensemble: losses {got['losses']} outside rtol {CAL_RTOL} "
             f"of the CPU's {want['losses']}")
    best = int(np.argmin(got["losses"]))
    if best != int(np.argmin(want["losses"])):
        miss(f"fit_ensemble: best restart {best} on the card, "
             f"{int(np.argmin(want['losses']))} on the CPU")
    q, q_cpu = calibrate.fit_queue_coeff(), \
        calibrate.fit_queue_coeff(device="cpu")
    q_rel = abs(q["queue_mw_per_duty"] - q_cpu["queue_mw_per_duty"]) \
        / q_cpu["queue_mw_per_duty"]
    if q_rel > QUEUE_RTOL:
        miss(f"fit_queue_coeff: {q['queue_mw_per_duty']} vs the CPU's "
             f"{q_cpu['queue_mw_per_duty']}")
    print(f"gradient path d (fit_ensemble {r} restarts x {steps} steps): "
          f"losses within {rel:.3g} relative of the CPU's, best restart "
          f"{best} (loss {got['best_loss']:.4f}) on both; posterior best "
          + ", ".join(f"{k} {p['best']:.3f}"
                      for k, p in got["posterior"].items())
          + f"; fit_queue_coeff {q['queue_mw_per_duty']:.4f} mW/duty "
          f"({q_rel:.3g} relative off the CPU)")


# phase 4 i: the fleet layer at full width (DEFAULT_POPULATION: 4
# archetypes, 9 timezones, 4 streams, L = 3, T = 720 at dt_s 60)
FLEET_DT = 60.0
FLEET_USERS = 4096              # benchmarks/fleet_bench.py's BENCH_USERS
FLEET_BIG, FLEET_SIZE = 100_000, 1e6    # examples/fleet_capacity.py
WEEK_USERS, WEEK_TRICKLE_MW = 256, 50.0
REF_USERS, REF_KEY = 24, 3      # a port-sampled draw with mixed survival
MC_USERS, MC_DRAWS, MC_DT = 256, 8, 120.0   # benchmarks/autoscale_bench.py
PARETO_USERS = 1024
# fleet curves and pod-hours, card vs CPU (the reference's parity budget)
CURVE_RTOL = 1e-6
FLEET_EXACT = ("time_to_empty_h", "shutdown", "day_hours")
FLEET_PER_USER = ("time_to_empty_h", "peak_skin_c", "end_soc", "shutdown",
                  "pod_hours", "day_hours")


@contextlib.contextmanager
def scan_checked(ds):
    """Hold every day-scan call made inside to its plain version on its
    own tables, at once (all outputs bit for bit), and drop it: records
    (N, full, whether it carried an initial SoC below 1) per call and the
    largest error in `stats`."""
    stats = {"calls": [], "worst": 0.0}
    real = ds.day_scan

    def checking(tables, full=False):
        import torch
        ys = real(tables, full)
        want = ds.day_scan_plain(tables, full)
        torch.cuda.synchronize()
        stats["worst"] = max(stats["worst"], compare(ys, want))
        soc0 = any(k in tables and bool((tables[k] < 1.0).any())
                   for k in ds.SOC0_KEYS)
        stats["calls"].append((int(tables["step_mw"].shape[-1]), full,
                               soc0))
        return ys

    ds.day_scan = checking
    try:
        yield stats
    finally:
        ds.day_scan = real


def fleet_equal(name: str, got, want, same_tables: bool) -> str:
    """A fleet report against the same call elsewhere: survival, shutdown
    and time-to-empty equal (a failure); on the same archetype tables
    every per-user output equal (a failure), on each device's own tables
    peak skin within rtol 1e-6 and end SoC within 1e-6 (the row stage
    puts some table entries an ulp apart between card and CPU); the
    curves and pod-hours within CURVE_RTOL (misses)."""
    import numpy as np
    if not np.array_equal(got.survives(), want.survives()):
        fail(f"{name}: survives() differs ({int(got.survives().sum())} vs "
             f"{int(want.survives().sum())})")
    for k in FLEET_EXACT + (FLEET_PER_USER if same_tables else ()):
        if not np.array_equal(getattr(got, k), getattr(want, k)):
            fail(f"{name}: {k} differs")
    off = []
    for k, rtol, atol in (("peak_skin_c", CURVE_RTOL, 0.0),
                          ("end_soc", CURVE_RTOL, 1e-6)):
        a, b = getattr(got, k), getattr(want, k)
        off.append(f"{k} {int((a != b).sum())} (max abs diff "
                   f"{float(np.max(np.abs(a - b))):.3g})")
        if not np.allclose(a, b, rtol=rtol, atol=atol):
            miss(f"{name}: {k} outside rtol {rtol:g} / atol {atol:g}")
    worst = 0.0
    for k in ("curve", "stream_curve", "pod_hours"):
        a, b = getattr(got, k), getattr(want, k)
        atol = CURVE_RTOL * float(np.max(np.abs(b))) if k != "pod_hours" \
            else 0.0
        worst = max(worst, float(np.max(np.abs(a - b)
                                        / np.maximum(np.abs(b), 1e-30))))
        if not np.allclose(a, b, rtol=CURVE_RTOL, atol=atol):
            miss(f"{name}: {k} outside rtol {CURVE_RTOL:g}")
    return (f"survive {int(got.survives().sum())} of {len(got)}, shutdown "
            f"{int(got.shutdown.sum())}; users not bit-equal: "
            + ", ".join(off) + f"; curves / pod-hours within {worst:.3g} "
            "relative")


def card_prep(spec, **kw):
    """`fleet.prepare_fleet` built on the CPU (its row stage and tables)
    and moved to the card: the card's fleet day on the CPU's tables."""
    import dataclasses
    import torch
    from repro_torch.core import fleet
    prep = fleet.prepare_fleet(spec, device="cpu", **kw)
    dev = torch.device("cuda")
    return dataclasses.replace(
        prep, xs_dev={k: v.to(dev) for k, v in prep.xs_dev.items()},
        device=dev)


def fleet_tables_diff() -> str:
    """How far the card's archetype tables (row stage on the card) sit
    from the CPU's: entries not bit-equal."""
    import torch
    from repro_torch.core import fleet
    got = fleet.prepare_fleet(fleet.DEFAULT_POPULATION, dt_s=FLEET_DT)
    want = fleet.prepare_fleet(fleet.DEFAULT_POPULATION, dt_s=FLEET_DT,
                               device="cpu")
    diff = {k: int((v.cpu() != want.xs_dev[k]).sum())
            for k, v in got.xs_dev.items()}
    total = sum(v.numel() for v in got.xs_dev.values())
    return (f"archetype tables card vs CPU: {sum(diff.values())} of {total} "
            f"entries not bit-equal ("
            + ", ".join(f"{k} {v}" for k, v in diff.items() if v) + ")")


def fleet_paths() -> tuple:
    """Phase 4 i: the fleet layer on the card against the CPU; returns
    (day-scan launches of its main-path runs, the kernel's largest error
    against its plain version on their tables)."""
    import math
    import numpy as np
    import torch
    from repro_torch.core import autoscale, dse, fleet, montecarlo
    from repro_torch.kernels import day_scan as ds
    spec = fleet.DEFAULT_POPULATION
    launches, worst = 0, 0.0
    print(fleet_tables_diff())

    # a. 4096 users, card vs CPU
    pop = fleet.sample_population(spec, FLEET_USERS, key=0)
    with scan_checked(ds) as chk:
        ds.LAUNCHES = ds.FULL_LAUNCHES = 0
        got = fleet.fleet_day(pop, dt_s=FLEET_DT)
        n, n_full = ds.LAUNCHES, ds.FULL_LAUNCHES
    chunks = math.ceil(FLEET_USERS / fleet.CHUNK_USERS)
    if (n, n_full) != (chunks, chunks):
        fail(f"fleet_day ({FLEET_USERS} users): {n} launches ({n_full} full "
             f"trace), want {chunks} (chunks x 1 day)")
    with scan_checked(ds) as chk2:
        ds.LAUNCHES = 0
        same = fleet.fleet_day(pop, dt_s=FLEET_DT,
                               prep=card_prep(spec, dt_s=FLEET_DT))
        launches += ds.LAUNCHES
    launches += n
    worst = max(worst, chk["worst"], chk2["worst"])
    want = fleet.fleet_day(pop, dt_s=FLEET_DT, device="cpu")
    print(f"fleet_day ({FLEET_USERS} users, dt_s {FLEET_DT:g}, T "
          f"{int(np.max(got.day_hours) * 3600 / FLEET_DT)}): {n} full-trace "
          f"launch(es) at N = {[c[0] for c in chk['calls']]}, each == plain "
          f"(17 outputs); vs the CPU: "
          f"{fleet_equal('fleet_day 4096', got, want, False)}; on the CPU's "
          f"tables: {fleet_equal('fleet_day 4096 (CPU tables)', same, want, True)}")

    # b. the example's 100 000 users: peak memory, a repeat, the head run
    # alone, the curve's integral
    big = fleet.sample_population(spec, FLEET_BIG, key=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ds.LAUNCHES = 0
    rep = fleet.fleet_day(big, dt_s=FLEET_DT, fleet_size=FLEET_SIZE)
    n = ds.LAUNCHES
    peak = torch.cuda.max_memory_allocated() - base
    chunks = math.ceil(FLEET_BIG / fleet.CHUNK_USERS)
    if n != chunks:
        fail(f"fleet_day ({FLEET_BIG} users): {n} launches, want {chunks}")
    with scan_checked(ds) as chk:
        ds.LAUNCHES = 0
        again = fleet.fleet_day(big, dt_s=FLEET_DT, fleet_size=FLEET_SIZE)
        head = fleet.fleet_day(big.take(np.arange(FLEET_USERS)),
                               dt_s=FLEET_DT, fleet_size=FLEET_SIZE)
        n_more = ds.LAUNCHES
    launches += n + n_more
    worst = max(worst, chk["worst"])
    for k in (*FLEET_PER_USER, "curve", "stream_curve"):
        if not np.array_equal(getattr(again, k), getattr(rep, k)):
            fail(f"fleet_day ({FLEET_BIG} users): a repeat changed {k}")
    for k in FLEET_PER_USER:
        if not np.array_equal(getattr(head, k),
                              getattr(rep, k)[:FLEET_USERS]):
            fail(f"fleet_day: the first {FLEET_USERS} users alone differ "
                 f"from the {FLEET_BIG}-user run in {k}")
    bin_hours = 24.0 / rep.curve.shape[0]
    integral = rep.curve_total.sum() * bin_hours
    scaled = rep.pod_hours.sum() * FLEET_SIZE / FLEET_BIG
    if not math.isclose(integral, scaled, rel_tol=1e-6):
        miss(f"fleet_day ({FLEET_BIG} users): curve integral {integral} vs "
             f"scaled pod-hours {scaled}")
    plan = rep.capacity_plan()
    print(f"fleet_day ({FLEET_BIG} users, fleet_size {FLEET_SIZE:g}): {n} "
          f"launches (chunks of {fleet.CHUNK_USERS}); peak device memory "
          f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held "
          f"(torch.cuda.max_memory_allocated); a repeat bit-equal; the "
          f"first {FLEET_USERS} users alone equal; curve integral "
          f"{integral:.6g} pod-h/day vs scaled pod-hours {scaled:.6g} "
          f"({abs(integral / scaled - 1):.3g} relative); survival "
          f"{rep.survival_rate():.4f}, autoscaled ${plan['autoscaled']['usd']:,.0f}"
          f"/day vs peak ${plan['peak_provisioned']['usd']:,.0f}/day; "
          f"{n_more} more launches held to plain")

    # c. the week: undercharged against the CPU, days >= 1 from soc0 < 1,
    # the recharged week against the single day
    wpop = fleet.sample_population(spec, WEEK_USERS, key=0)
    with scan_checked(ds) as chk:
        ds.LAUNCHES = 0
        under = fleet.fleet_day(wpop, dt_s=FLEET_DT, n_days=7,
                                overnight_charge_mw=WEEK_TRICKLE_MW)
        n_under = ds.LAUNCHES
        week = fleet.fleet_day(wpop, dt_s=FLEET_DT, n_days=7)
        day = fleet.fleet_day(wpop, dt_s=FLEET_DT)
        n = ds.LAUNCHES
    launches += n
    worst = max(worst, chk["worst"])
    if n_under != 7 or n != 15:
        fail(f"week: {n_under} launches undercharged, {n} in all; want 7 "
             f"and 15")
    started = sum(c[2] for c in chk["calls"][:7])
    if started != 6:
        fail(f"week: {started} of the undercharged days 1-6 started below "
             f"a full battery, want 6")
    cpu = fleet.fleet_day(wpop, dt_s=FLEET_DT, n_days=7,
                          overnight_charge_mw=WEEK_TRICKLE_MW, device="cpu")
    with scan_checked(ds) as chk:
        ds.LAUNCHES = 0
        same = fleet.fleet_day(wpop, dt_s=FLEET_DT, n_days=7,
                               overnight_charge_mw=WEEK_TRICKLE_MW,
                               prep=card_prep(spec, dt_s=FLEET_DT))
        launches += ds.LAUNCHES
    worst = max(worst, chk["worst"])
    scale = float(day.curve.max())
    drift = float(np.max(np.abs(week.curve - day.curve))) / scale
    if not np.allclose(week.curve, day.curve, rtol=1e-6, atol=1e-6 * scale):
        miss(f"week: the recharged week's curve {drift:.3g} off the day's")
    print(f"week ({WEEK_USERS} users x 7 days): undercharged "
          f"({WEEK_TRICKLE_MW:g} mW dock) 7 launches, days 1-6 from soc0 < 1, "
          f"each == plain; vs the CPU: "
          f"{fleet_equal('undercharged week', under, cpu, False)}; on the "
          f"CPU's tables: "
          f"{fleet_equal('undercharged week (CPU tables)', same, cpu, True)}"
          f"; survival "
          f"{under.survival_rate():.4f} vs one day {day.survival_rate():.4f}; "
          f"recharged week's curve within {drift:.3g} of the day's")

    # d. the per-user oracle on a population with mixed survival
    rpop = fleet.sample_population(spec, REF_USERS, key=REF_KEY)
    with scan_checked(ds) as chk:
        ds.LAUNCHES = 0
        got = fleet.fleet_day(rpop, dt_s=FLEET_DT)
        n = ds.LAUNCHES
    launches += n
    worst = max(worst, chk["worst"])
    ref = fleet.reference_fleet(rpop, dt_s=FLEET_DT)
    surv = int(got.survives().sum())
    if not 0 < surv < REF_USERS:
        fail(f"reference_fleet: {surv} of {REF_USERS} survive, want a mix")
    print(f"reference_fleet ({REF_USERS} users, key {REF_KEY}) vs fleet_day "
          f"on the card: {fleet_equal('reference_fleet', got, ref, True)}")

    # e. the autoscaler, card vs CPU
    bh = 24.0 / got.curve.shape[0]
    inst = autoscale.simulate(autoscale.INSTANT, want.curve_total, bh,
                              stream_curve=want.stream_curve_total)
    integral = want.curve_total.sum() * bh
    if inst["dropped_pod_hours"] != 0.0 or not math.isclose(
            inst["provisioned_pod_hours"], integral, rel_tol=1e-5):
        miss(f"autoscale INSTANT: {inst['provisioned_pod_hours']} pod-h, "
             f"dropped {inst['dropped_pod_hours']}; the curve integral "
             f"{integral}")
    spec_a = autoscale.AutoscalerSpec()
    sim = autoscale.simulate(spec_a, want.curve_total, bh,
                             stream_curve=want.stream_curve_total)
    want_plan = autoscale.simulate(spec_a, want.curve_total, bh,
                                   stream_curve=want.stream_curve_total,
                                   device="cpu")
    rel = 0.0
    for k, v in want_plan.items():
        if k in ("spec",):
            continue
        a, b = np.asarray(sim[k], float), np.asarray(v, float)
        rel = max(rel, float(np.max(np.abs(a - b)
                                    / np.maximum(np.abs(b), 1e-30))))
        if not np.allclose(a, b, rtol=1e-6, atol=0.0):
            miss(f"autoscale.simulate: {k} {sim[k]} vs the CPU's {v}")
    print(f"autoscale: INSTANT provisions {inst['provisioned_pod_hours']:.6g} "
          f"pod-h = the curve integral {integral:.6g}, drops 0; the default "
          f"spec within {rel:.3g} relative of the CPU (dropped "
          f"{sim['dropped_stream_hours']:.4g} stream-h, "
          f"{sim['scale_down_events']} scale-downs)")

    # f. Monte Carlo (benchmarks/autoscale_bench.py's configuration)
    kw = dict(n_draws=MC_DRAWS, key=0, dt_s=MC_DT, fleet_size=FLEET_SIZE,
              autoscaler=autoscale.AutoscalerSpec())
    with scan_checked(ds) as chk:
        ds.LAUNCHES = 0
        dist = montecarlo.fleet_distribution(spec, MC_USERS, **kw)
        slow = montecarlo.fleet_distribution(spec, MC_USERS,
                                             reuse_prep=False, **kw)
        n = ds.LAUNCHES
    launches += n
    worst = max(worst, chk["worst"])
    if n != 2 * MC_DRAWS:
        fail(f"fleet_distribution: {n} launches, want {2 * MC_DRAWS}")
    cpu = montecarlo.fleet_distribution(spec, MC_USERS, device="cpu", **kw)
    keys = ("survival_draws", "tte_draws", "curve_draws",
            "stream_curve_draws", "usd_draws", "dynamic_usd_draws",
            "dropped_stream_h_draws")
    for k in keys:
        if not np.array_equal(getattr(dist, k), getattr(slow, k)):
            fail(f"fleet_distribution: reuse_prep changed {k}")
    for k in ("survival_draws", "tte_draws"):
        if not np.array_equal(getattr(dist, k), getattr(cpu, k)):
            fail(f"fleet_distribution: {k} differ from the CPU's")
    rel = 0.0
    for k in keys[2:]:
        a, b = getattr(dist, k), getattr(cpu, k)
        rel = max(rel, float(np.max(np.abs(a - b)
                                    / np.maximum(np.abs(b), 1e-30))))
        if not np.allclose(a, b, rtol=1e-6, atol=1e-6 * float(b.max())):
            miss(f"fleet_distribution: {k} outside 1e-6 of the CPU's")
    sv = dist.survival_rate()
    print(f"fleet_distribution ({MC_USERS} users x {MC_DRAWS} draws, dt_s "
          f"{MC_DT:g}): {n} launches (reuse_prep True and False, "
          f"bit-identical), each == plain; survival draws and TTE equal to "
          f"the CPU's, curves and $ within {rel:.3g}; survival "
          f"{sv['mean']:.4f} [{sv['lo']:.4f}, {sv['hi']:.4f}]")

    # g. the fleet front, with and without an autoscaler
    for scaler in (None, autoscale.AutoscalerSpec()):
        with scan_checked(ds) as chk:
            ds.LAUNCHES = 0
            front = dse.fleet_pareto(n_users=PARETO_USERS,
                                     autoscaler=scaler)
            n = ds.LAUNCHES
        launches += n
        worst = max(worst, chk["worst"])
        cpu = dse.fleet_pareto(n_users=PARETO_USERS, autoscaler=scaler,
                               device="cpu")
        name = f"fleet_pareto ({'autoscaled' if scaler else 'ideal'})"
        if n != len(front.rows) or len(front.rows) != 9:
            fail(f"{name}: {n} launches for {len(front.rows)} variants")
        if not np.array_equal(front.front_mask, cpu.front_mask):
            fail(f"{name}: front differs from the CPU's")
        rel = 0.0
        for g, w in zip(front.rows, cpu.rows):
            if set(g) != set(w) or g["variant"] != w["variant"]:
                fail(f"{name}: rows differ in keys or order")
            for k, v in w.items():
                if isinstance(v, str):
                    continue
                rel = max(rel, abs(g[k] - v) / max(abs(v), 1e-30))
                if not math.isclose(g[k], v, rel_tol=1e-6, abs_tol=1e-9):
                    miss(f"{name} {w['variant']}: {k} {g[k]} vs the CPU's "
                         f"{v}")
        print(f"{name} (9 variants x {PARETO_USERS} users): {n} launches, "
              f"each == plain; front {int(front.front_mask.sum())} equal to "
              f"the CPU's, rows within {rel:.3g} relative")
    return launches, worst


def fleet_timing() -> str:
    """Phase 5, fleet layer: fleet_day warm ms at 4096 and 100 000 users
    (host clock, ending in the copy to the host), the kernel's ms per
    fleet launch (CUDA events) beside its bound, a profile of one 4096-user
    call, Monte Carlo draws/s, autoscale.simulate ms and kernels a call,
    fleet_pareto ms."""
    import numpy as np
    import torch
    from repro_torch.core import autoscale, dse, fleet, montecarlo
    from repro_torch.kernels import day_scan as ds
    spec = fleet.DEFAULT_POPULATION
    out = []

    def wall(fn, reps):
        fn()
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.mean(ms)), float(np.min(ms))

    pop = fleet.sample_population(spec, FLEET_USERS, key=0)
    big = fleet.sample_population(spec, FLEET_BIG, key=0)
    day = lambda: fleet.fleet_day(pop, dt_s=FLEET_DT)     # noqa: E731
    m4, n4 = wall(day, 5)
    m1, n1 = wall(lambda: fleet.fleet_day(big, dt_s=FLEET_DT,
                                          fleet_size=FLEET_SIZE), 3)
    out.append(f"fleet_day warm (host clock, ends in the copy to the host): "
               f"{FLEET_USERS} users mean {m4:.2f} ms, min {n4:.2f} ms (5 "
               f"calls); {FLEET_BIG} users mean {m1:.2f} ms, min {n1:.2f} ms "
               f"(3 calls, {m1 * 1e3 / FLEET_BIG:.2f} us a user-day)")
    # the kernel alone on a fleet launch's tables (4096, and a 100 000-user
    # run's full chunk)
    for p in (pop, big.take(np.arange(fleet.CHUNK_USERS))):
        seen = []
        real = ds.day_scan

        def grab(tables, full=False):
            seen.append(tables)
            return real(tables, full)

        ds.day_scan = grab
        try:
            fleet.fleet_day(p, dt_s=FLEET_DT)
        finally:
            ds.day_scan = real
        tables = seen[0]
        n, t, n_lvl = ds._shape(tables)
        ds._day_scan_cuda(tables, True)
        k_ms = cuda_ms(lambda: ds._day_scan_cuda(tables, True), 20)
        b_ms, b_by = bound_ms(n, t, n_lvl, len(ds.TRACE_OUTS))
        out.append(f"day_scan full trace at a fleet launch (N = {n}, T = {t}, "
                   f"L = {n_lvl}, CUDA events, 20 launches): {k_ms:.4f} ms, "
                   f"bound {b_ms:.5f} ms by {b_by} ({b_ms / k_ms:.1%} of it)")
        FLEET_KERNEL_MS[n] = (k_ms, b_ms, b_by)
        del seen, tables
    out.append(profile_device(day, f"fleet_day {FLEET_USERS} users",
                              tags=("day_scan",), host_ops=False))
    kw = dict(n_draws=MC_DRAWS, key=0, dt_s=MC_DT, fleet_size=FLEET_SIZE,
              autoscaler=autoscale.AutoscalerSpec())
    mc, mc_min = wall(lambda: montecarlo.fleet_distribution(
        spec, MC_USERS, **kw), 2)
    out.append(f"fleet_distribution ({MC_USERS} users x {MC_DRAWS} draws, "
               f"dt_s {MC_DT:g}, autoscaled, warm, host clock, 2 calls): "
               f"mean {mc:.1f} ms = {MC_DRAWS * 1e3 / mc:.2f} draws/s (best "
               f"{MC_DRAWS * 1e3 / mc_min:.2f})")
    rep = fleet.fleet_day(pop, dt_s=FLEET_DT)
    sim = lambda: autoscale.simulate(                      # noqa: E731
        autoscale.AutoscalerSpec(), rep.curve_total, 1.0,
        stream_curve=rep.stream_curve_total)
    a_ms, a_min = wall(sim, 5)
    out.append(f"autoscale.simulate (default spec, 24 x 12 substeps, warm, "
               f"host clock, 5 calls): mean {a_ms:.2f} ms, min {a_min:.2f} "
               f"ms\n" + profile_device(sim, "autoscale.simulate", tags=(),
                                        host_ops=False))
    for scaler in (None, autoscale.AutoscalerSpec()):
        f_ms, _ = wall(lambda: dse.fleet_pareto(n_users=PARETO_USERS,
                                                autoscaler=scaler), 1)
        out.append(f"fleet_pareto (9 variants x {PARETO_USERS} users, "
                   f"{'autoscaled' if scaler else 'ideal'}, warm, host "
                   f"clock): {f_ms:.1f} ms")
    return "\n".join(out)


FLEET_KERNEL_MS: dict = {}      # N -> (kernel ms, bound ms, bound by)


def gradient_timing(cap: float) -> str:
    """Phase 5, gradient path: ms per Adam step of 4 h c (host clock over
    warm steps: one batched value-and-grad of all restarts, the Adam
    update and the projection) and a profile of one step; ms per
    fit_ensemble step; sensitivity_map ms; the example's full
    optimize_policy estimated from these."""
    import numpy as np
    import torch
    from repro_torch.core import calibrate, daysim, design, dse
    plat, d, sched, pol = GRAD_DAY
    row = daysim.DEFAULT_DESIGNS[d]
    f = daysim.relaxed_day_fn(plat, sched, pol, row, dt_s=GRAD_DT)
    space = design.policy_space()
    vg = torch.func.vmap(torch.func.grad_and_value(dse.policy_loss(f, cap)))
    state = {"pts": space.clip(space.uniform_sample(0, GRAD_RESTARTS,
                                                    "cuda"))}
    state["adam"] = design.adam_init(state["pts"])

    def step():
        grads, _ = vg(state["pts"])
        new, state["adam"] = design.adam_update(state["pts"], grads,
                                                state["adam"], 0.08)
        state["pts"] = space.clip(new)

    step()
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.mean(ms))
    prof = profile_device(step, "one Adam step of optimize_policy",
                          tags=(), host_ops=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    daysim.simulate(plat, row, sched, pol, dt_s=GRAD_DT)
    sim_ms = (time.perf_counter() - t0) * 1e3
    r, steps = ENSEMBLE
    calibrate.fit_ensemble(n_restarts=r, steps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calibrate.fit_ensemble(n_restarts=r, steps=steps)
    ens_ms = (time.perf_counter() - t0) * 1e3 / steps
    dse.sensitivity_map("aria2")
    sens = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dse.sensitivity_map("aria2")
        sens.append((time.perf_counter() - t0) * 1e3)
    full_s = ((EXAMPLE_STEPS + 1) * step_ms
              + (1 + GRAD_RESTARTS) * sim_ms) / 1e3
    return (f"optimize_policy Adam step ({GRAD_RESTARTS} restarts, 540 "
            f"steps, batched value-and-grad + update, host clock, mean of "
            f"2 warm): {step_ms:.1f} ms; simulate (one full-trace launch): "
            f"{sim_ms:.2f} ms; the example's {EXAMPLE_STEPS}-step "
            f"optimize_policy estimated at {full_s:.1f} s "
            f"(({EXAMPLE_STEPS} + 1) steps + {1 + GRAD_RESTARTS} simulates)\n"
            f"{prof}\nfit_ensemble ({r} restarts, {steps} steps, warm, host "
            f"clock): {ens_ms:.3f} ms per step\nsensitivity_map (768 "
            f"points, one reverse pass, warm, host clock, 3 calls): mean "
            f"{np.mean(sens):.2f} ms, min {np.min(sens):.2f} ms")


def steady_state_timing() -> str:
    """Phase 5, steady state: the joint front's ms (host clock over warm
    calls, each ending in its copies to the host) and a profile."""
    import numpy as np
    import torch
    from repro_torch.core import dse
    dse.joint_pareto()
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dse.joint_pareto()
        ms.append((time.perf_counter() - t0) * 1e3)
    report, _ = profile_queries(dse.joint_pareto, 3, "joint_pareto call")
    return (f"joint_pareto (2304 points, warm, host clock, 5 calls): mean "
            f"{np.mean(ms):.3f} ms, min {np.min(ms):.3f} ms\n{report}")


def batch_timing(twin) -> str:
    """Phase 5, batched: ms per item of warm `query_batch` calls at K = 1,
    4 and 16 (host clock from a synchronize to the copy of the summary
    to the host), row-stage passes per batch and a profile of one K = 16
    batch."""
    import numpy as np
    import torch
    from repro_torch.core import daysim
    queries = governor_grids(daysim, 16)
    per_item = {}
    for k in (1, 4, 16):
        twin.query_batch(queries[:k])
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            twin.query_batch(queries[:k])
            ms.append((time.perf_counter() - t0) * 1e3)
        per_item[k] = float(np.mean(ms)) / k
    passes = {}
    for k in (1, 16):
        p0 = daysim.ROW_STAGE_STATS["passes"]
        twin.query_batch(queries[:k])
        passes[k] = daysim.ROW_STAGE_STATS["passes"] - p0
    report, _ = profile_queries(lambda: twin.query_batch(queries), 3,
                                "K = 16 batch")
    return (f"twin batched (warm query_batch of K default-grid what-ifs, mean "
            f"of 5): ms per item "
            + ", ".join(f"K={k} {v:.3f}" for k, v in per_item.items())
            + f"; row-stage passes per batch K=1 {passes[1]}, K=16 "
            f"{passes[16]}\n{report}")


def _bound(n_bytes: float, n_ops: float, dtype: str) -> tuple:
    """(bound ms, "bytes" | "operations"): the larger of the bytes over
    HBM bandwidth and the operations over the peak for `dtype`."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def flash_bound(q, k, causal: bool, window) -> tuple:
    """Bound of one attention call: q, k, v read once and o written once;
    the q.k and p.v products (2 flops a multiply-add) over the key
    positions these masks leave."""
    import numpy as np
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    n_bytes = (2 * B * Sq * H + 2 * B * Sk * KvH) * Dh * q.element_size()
    qi = np.arange(Sq)
    hi = np.minimum(qi, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qi - window + 1) if window is not None else 0 * qi
    pairs = float(np.clip(hi - lo + 1, 0, None).sum())
    return _bound(n_bytes, 4.0 * B * H * Dh * pairs, str(q.dtype)[6:])


def ssd_ops(x, Bm, chunk: int) -> float:
    """Products of one SSD scan (2 flops a multiply-add): per chunk of L
    rows C.B and W.(x dt) over the L(L+1)/2 pairs i >= j, C.state and
    the state update."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    lens = [min(chunk, s - c) for c in range(0, s, chunk)]
    return b * h * sum(L * (L + 1) / 2 * 2 * (n + p) + 4 * L * p * n
                       for L in lens)


def ssd_bound(x, Bm, chunk: int) -> tuple:
    """Bound of one SSD scan: x, B, C, dt, A read once and y written
    once; the products of `ssd_ops`."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    n_bytes = (2 * b * s * h * p + 2 * b * s * g * n) * x.element_size() \
        + 4 * (b * s * h + h)
    return _bound(n_bytes, ssd_ops(x, Bm, chunk), str(x.dtype)[6:])


def ssd_bwd_bound(x, Bm, chunk: int) -> tuple:
    """Bound of one SSD backward: x, dy, B, C, dt, A read once and dx,
    dB, dC, ddt, dA written once; 2.5 x the forward's products (as the
    flash backward's bound counts)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    n_bytes = (3 * b * s * h * p + 4 * b * s * g * n) * x.element_size() \
        + 4 * (2 * b * s * h + 2 * h)
    return _bound(n_bytes, 2.5 * ssd_ops(x, Bm, chunk), str(x.dtype)[6:])


def ssd_scratch_bytes(x, Bm) -> tuple:
    """(group-state bytes, re-read input bytes) the kernel's split moves
    beyond the function's own traffic (not part of its bound): launch 1
    writes G - 1 f32 states, launch 2 reads them and writes G, launch 3
    reads G; launch 1 reads x, B and dt of the first G - 1 groups again."""
    from repro_torch.kernels import ssd_scan as ss
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    G = ss.n_groups(s)
    if G == 1:
        return 0.0, 0.0
    states = (4 * G - 2) * b * h * n * p * 4.0
    part = (G - 1) / G
    reread = part * ((b * s * h * p + b * s * g * n) * x.element_size()
                     + 4 * b * s * h)
    return states, reread


def sdpa_call(q, k, v, causal: bool, window) -> tuple:
    """`scaled_dot_product_attention` on the port's (B, S, H, Dh) tensors
    (the yardstick only; the port never calls it): GQA through
    `enable_gqa`, a window through a boolean mask (True = attend).
    Returns (the call, the backend PyTorch's dispatcher picks for it,
    by `torch._fused_sdp_choice`, or "not measured")."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
    mask = None
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    is_causal = causal and mask is None
    try:
        backend = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, mask, 0.0, is_causal, **kw)).name
    except (AttributeError, TypeError, RuntimeError):
        backend = "not measured"
    return (lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=is_causal, **kw)), backend


def hold(name: str, got, want, atol: float, rtol: float) -> float:
    """Kernel output vs the plain version's: finite and allclose; returns
    the largest absolute error."""
    import torch
    torch.cuda.synchronize()
    a, w = got.float(), want.float()
    if a.shape != w.shape or not bool(torch.isfinite(a).all()):
        fail(f"{name}: kernel output not finite or of shape {a.shape}")
    err = float((a - w).abs().max())
    if not torch.allclose(a, w, atol=atol, rtol=rtol):
        miss(f"{name}: kernel off the plain version by {err} (atol {atol}, "
             f"rtol {rtol})")
    print(f"{name}: kernel vs plain, max abs err {err:.3g} (max |plain| "
          f"{float(w.abs().max()):.3g}, atol {atol:g}, rtol {rtol:g})")
    return err


def rel_rms(a, b) -> float:
    """RMS of a - b over the RMS of b, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def check_flash_rounding(got, q, k, v) -> None:
    """The bf16 kernel rounds p to v's dtype before the PV product and sums
    l from the unrounded p (the reference's flash_attention.py:72).  The
    plain version on the kernel's own tiles (`flash_attention.TILES`) has
    the same running max, so the same p, and differs from the kernel only
    by float32 sum order; that plain version with p left unrounded (v in
    float32) must differ by more than FLASH_ROUNDING_LIMIT."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn import attention as attn
    bq, bk = fa.TILES[q.dtype]
    tiles = {"causal": True, "chunk_q": bq, "chunk_k": bk}
    want = attn.chunked_attention(q, k, v, **tiles)
    kernel = rel_rms(got, want)
    control = rel_rms(attn.chunked_attention(q, k, v.float(), **tiles),
                      want)
    if not kernel <= FLASH_ROUNDING_LIMIT < control:
        miss(f"flash bf16 rounding: kernel rel RMS {kernel:.3g}, unrounded-p "
             f"control {control:.3g}, limit {FLASH_ROUNDING_LIMIT:g} must lie "
             f"between them")
    print(f"flash bf16 rounding (plain on the kernel's {bq} x {bk} tiles): "
          f"kernel rel RMS err {kernel:.3g}, limit {FLASH_ROUNDING_LIMIT:g}, "
          f"unrounded-p control {control:.3g}")


def check_ssd_bf16(got, want, x, dt, A, Bm, Cm, label: str,
                   chunk: int = 64) -> None:
    """The bf16 SSD kernel against the plain version at `chunk`: relative
    RMS error under SSD_BF16_LIMIT, which the plain version with x dt and
    W rounded to bf16 before their product (a tensor-core shortcut) must
    exceed."""
    from repro_torch.kernels import ssd_scan as ss
    kernel = rel_rms(got, want)
    control = rel_rms(ss.ssd_scan_rounded_plain(x, dt, A, Bm, Cm,
                                                chunk=chunk), want)
    if not kernel <= SSD_BF16_LIMIT < control:
        miss(f"{label}: kernel rel RMS {kernel:.3g}, bf16-product control "
             f"{control:.3g}, limit {SSD_BF16_LIMIT:g} must lie between them")
    print(f"{label}: kernel rel RMS err {kernel:.3g}, limit "
          f"{SSD_BF16_LIMIT:g}, bf16-product control {control:.3g}")


def check_lm_kernels(dev) -> dict:
    """Phase 6: flash and SSD kernels vs their plain versions."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)) \
            .to(dtype)

    worst = {"flash_attention": 0.0, "ssd_scan": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        tol = LM_TOL[str(dtype)[6:]]
        for B, S, H, KvH, Dh, window in ((B_PREFILL, S_PREFILL, 32, 32, 64,
                                          None),
                                         (1, 1000, 16, 4, 128, 96)):
            q = rn((B, S, H, Dh), dtype)
            k, v = rn((B, S, KvH, Dh), dtype), rn((B, S, KvH, Dh), dtype)
            bf16 = dtype == torch.bfloat16
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            err = hold(f"flash B={B} S={S} H={H} KvH={KvH} Dh={Dh} "
                       f"window={window} {str(dtype)[6:]}", got,
                       fa.flash_attention_plain(q, k, v, causal=True,
                                                window=window),
                       FLASH_BF16_ATOL if bf16 else tol,
                       FLASH_BF16_RTOL if bf16 else tol)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            if bf16 and S == S_PREFILL:
                check_flash_rounding(got, q, k, v)
        # dt x 0.05 (slow decay) makes the state carried between the
        # split's groups count in y; dt x 1 is the reference tests' range
        for b, s, h, g, n, dt_scale in ((B_PREFILL, S_PREFILL, 64, 1, 64, 1),
                                        (B_PREFILL, S_PREFILL, 64, 1, 64,
                                         0.05),
                                        (B_PREFILL, 1000, 64, 1, 64, 0.05),
                                        (1, 1024, 8, 2, 128, 0.05)):
            x = rn((b, s, h, 64), dtype, 0.5)
            dt = dt_scale * torch.nn.functional.softplus(
                rn((b, s, h), torch.float32))
            A = -torch.exp(rn((h,), torch.float32, 0.3))
            Bm, Cm = rn((b, s, g, n), dtype, 0.3), rn((b, s, g, n), dtype,
                                                       0.3)
            label = f"ssd b={b} s={s} h={h} g={g} n={n} dt x{dt_scale:g} " \
                f"{str(dtype)[6:]}"
            got = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
            want = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=64)
            err = hold(label, got, want, max(tol, 1e-4), 5 * tol)
            worst["ssd_scan"] = max(worst["ssd_scan"], err)
            if dtype == torch.bfloat16:
                check_ssd_bf16(got, want, x, dt, A, Bm, Cm, label)
            # the f32 group states of the split (the bf16 path's split
            # products) at the float32 tolerance
            hold(f"{label} group states",
                       ss.ssd_group_states_cuda(x, dt, A, Bm, Cm),
                       ss.ssd_split_states_plain(x, dt, A, Bm, Cm, chunk=64),
                       max(LM_TOL["float32"], 1e-4), 5 * LM_TOL["float32"])
    return worst


def check_golden_lm(dev, golden_file: str, base_cfg, model) -> None:
    """Phases 8 and 13: the float32 prefill step at full width, cut in
    depth as the golden says, against the JAX reference's golden logits;
    the same in bf16 must miss them."""
    import dataclasses
    import torch
    from repro_torch import convert
    from repro_torch.golden import golden_errors, rank_miss
    from repro_torch.launch import steps
    from repro_torch.nn import core
    golden = json.loads((ROOT / "src" / "repro_torch" / "data"
                         / golden_file).read_text())
    cut = {k: golden[k] for k in ("n_layers", "dec_layers") if k in golden}
    cfg = dataclasses.replace(base_cfg, compute_dtype=torch.float32, **cut)
    tree = convert.lm_params_numpy(cfg, golden["seed"])
    if convert.params_checksum(tree) != golden["params_sha256"]:
        fail(f"golden {golden['arch']}: the seeded numpy weights differ from "
             f"the golden's (numpy's stream changed), not a parity failure")
    tol = golden["atol_rel_to_spread"] * golden["spread"]
    rtol1 = golden.get("top1_rtol")
    inputs = {"tokens": torch.as_tensor(golden["tokens"], device=dev)}
    if "frames_seed" in golden:         # whisper's stub frame embeddings
        frames = golden_frames(cfg, len(golden["tokens"]),
                               golden["frames_seed"])
        if frames_sha256(frames) != golden["frames_sha256"]:
            fail(f"golden {golden['arch']}: the seeded frames differ from "
                 f"the golden's (numpy's stream changed)")
        inputs["frames"] = torch.as_tensor(frames, device=dev)
    misses = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        params = convert.lm_params_from_numpy(tree, c, dev)
        out = steps.make_prefill_step(c, model)(params, inputs)
        h = out[0] if isinstance(out, tuple) else out
        logits = core.unembed_logits(params["embed"]["table"], h).float()
        if not bool(torch.isfinite(logits).all()):
            fail(f"golden {golden['arch']}: {dtype} logits not finite")
        misses[dtype] = golden_errors(logits, golden) + (
            rank_miss(logits, golden, tol),)
        del params, out, h
    del tree
    err, rel1, rank = misses[torch.float32]
    if err > tol or rank is not None or (rtol1 is not None and rel1 > rtol1):
        miss(f"golden {golden['arch']}: float32 logits off the reference by "
             f"{err} (tol {tol}), top-1 by {rel1} relative (tol {rtol1}), "
             f"top-8 rank miss at (row, rank) {rank}")
    err16, rel16, rank16 = misses[torch.bfloat16]
    if err16 <= tol and (rtol1 is None or rel16 <= rtol1):
        miss(f"golden {golden['arch']}: the bf16 control is within the "
             f"tolerance ({err16} <= {tol}, top-1 {rel16}): the tolerance "
             f"does not tell the precisions apart")
    top1 = "" if rtol1 is None else (
        f" (top-1 left out: it is held to {rtol1:g} of itself; float32 "
        f"{rel1:.3g}, bf16 {rel16:.3g})")
    layers = "+".join(str(v) for v in cut.values())
    print(f"golden ({golden['arch']} full width, {layers} layers, "
          f"B={len(golden['tokens'])} S={len(golden['tokens'][0])}): weights "
          f"checksum equal; float32 logits max abs err {err:.4g}{top1}, "
          f"top-8 rank miss at {rank}; tol {tol:.4g} "
          f"({golden['atol_rel_to_spread']:g} x spread "
          f"{golden['spread']:.4g}); bf16 control err {err16:.4g}, top-8 "
          f"rank miss at (row, rank) {rank16}")


def golden_frames(cfg, batch: int, seed: int):
    """A whisper golden's stub frames: (batch, audio_frames, D) standard
    normal float32 from numpy's generator seeded `seed` (as
    tests/torch_golden_whisper.py draws them)."""
    import numpy as np
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.audio_frames, cfg.d_model), dtype=np.float32)


def frames_sha256(a) -> str:
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a, "<f4").tobytes()) \
        .hexdigest()


def profile_device(fn, label: str, reps: int = 1,
                   tags=("flash_kernel", "ssd_kernel"),
                   host_ops: bool = True) -> str:
    """Device time per call of `fn` by kernel, from torch.profiler: the
    device-busy ms beside the host-clock wall ms, the ms of the kernels
    whose names hold one of `tags` and the top kernels.  Without
    `host_ops` the profiler records device activity only (a call of
    ~10^5 kernels then takes seconds, not minutes, to summarize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((dev_us / reps, e.count / reps, e.key))
    if not rows:
        return f"profile ({label}): the profiler saw no device time " \
            "(not measured)"
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3

    def share(tag):
        return sum(r[0] for r in rows if tag in r[2]) / 1e3

    top = "; ".join(f"{k[:40]} {us / 1e3:.3f} ms x{c:g}"
                    for us, c, k in rows[:6])
    return (f"profile ({label}, per call): wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({100 * (1 - busy / wall):.1f} % idle) in "
            f"{sum(r[1] for r in rows):g} kernels; "
            + "".join(f"{t} {share(t):.2f} ms; " for t in tags)
            + f"top: {top}")


def check_served(batch, params32, params16, cfg32, cfg16, prefill32, dec,
                 dev, model, top1_rtol=None) -> None:
    """Phases 9 and 14 for one batch of served requests: the tokens the
    Server fed (left-padded prompts, then all but the last new token)
    through the float32 forward give, at each position, the token the
    Server chose next (the first one through the prefill step); teacher-
    forced through `decode_step` they give the forward's logits within
    DEC_ATOL_REL x their spread, and the bf16 forward misses that
    tolerance.  With `top1_rtol` (gemma3-4b: its top-1 logit, the row's
    own token, is ~2200 and moves with float32 rounding by a few 1e-6 of
    itself, as in its golden) each position's top-1 is held to that
    relative tolerance and left out of the absolute one."""
    import numpy as np
    import torch
    from repro_torch.golden import logit_errors, spread
    from repro_torch.nn import core
    S = max(len(r.prompt) for r in batch)
    n_new = len(batch[0].out_tokens)
    seq = np.zeros((len(batch), S + n_new - 1), np.int64)
    for i, r in enumerate(batch):
        seq[i, S - len(r.prompt):S] = r.prompt
        seq[i, S:] = r.out_tokens[:-1]
    seq = torch.as_tensor(seq, device=dev)
    table = params32["embed"]["table"]
    out = prefill32(params32, {"tokens": seq[:, :S]})
    h_last = out[0] if isinstance(out, tuple) else out
    first = torch.argmax(core.unembed_logits(table, h_last), dim=-1).tolist()
    del out
    ref = core.unembed_logits(table, model.forward(params32, cfg32, seq)[0])
    tol = DEC_ATOL_REL * spread(ref)
    top2 = torch.topk(ref[:, S - 1:], 2, dim=-1)
    gap = (top2.values[..., 0] - top2.values[..., 1]).cpu().numpy()
    chose = top2.indices[..., 0].cpu().numpy()
    for i, r in enumerate(batch):
        if r.out_tokens[0] != first[i]:
            miss(f"Server {cfg32.name} request {r.rid}: first token "
                 f"{r.out_tokens[0]} != prefill argmax {first[i]}")
        for t, tok in enumerate(r.out_tokens):
            if tok != chose[i, t] and gap[i, t] > 2 * tol:
                miss(f"Server {cfg32.name} request {r.rid}: token {t} is "
                     f"{tok}, the float32 forward's argmax is {chose[i, t]}")
    cache = model.init_cache(cfg32, len(batch), seq.shape[1], torch.float32,
                             dev)
    is_top1 = torch.zeros_like(ref, dtype=torch.bool).scatter(
        -1, ref.argmax(-1, keepdim=True), True)

    def errors(lg, t=slice(None)):
        """(max abs error against the forward's logits, at position t or
        at all, and the max relative error of the forward's top-1)."""
        return logit_errors(lg, ref[:, t], is_top1[:, t],
                            top1_rtol is not None)

    err, rel1 = 0.0, 0.0
    for t in range(seq.shape[1]):
        lg, cache = dec(params32, seq[:, t], cache, t)
        e, r1 = errors(lg, t)
        err, rel1 = max(err, e), max(rel1, r1)
    h16, _ = model.forward(params16, cfg16, seq)
    err16, rel16 = errors(core.unembed_logits(params16["embed"]["table"],
                                              h16))
    ok1 = top1_rtol is None or rel1 <= top1_rtol < rel16
    if not (err <= tol < err16 and ok1):
        miss(f"Server {cfg32.name} requests {[r.rid for r in batch]}: "
             f"decode_step logits off the float32 forward by {err}, bf16 "
             f"forward by {err16}; tol {tol} must lie between them; top-1 "
             f"relative {rel1} / {rel16} (tol {top1_rtol})")
    print(f"Server {cfg32.name} requests {[r.rid for r in batch]} (prompts "
          f"{[len(r.prompt) for r in batch]}, padded to {S}): {n_new} tokens "
          f"each, first vs prefill argmax {first}, all vs float32 forward "
          f"argmax (smallest top-2 gap {gap.min():.3g}); decode_step logits "
          f"over {seq.shape[1]} positions max abs err {err:.4g}, tol "
          f"{tol:.4g} ({DEC_ATOL_REL:g} x spread {tol / DEC_ATOL_REL:.4g}), "
          f"bf16 forward err {err16:.4g}"
          + ("" if top1_rtol is None else
             f"; top-1 left out, held to {top1_rtol:g} of itself: float32 "
             f"{rel1:.3g}, bf16 {rel16:.3g}"))


def serve_and_check(cfg32, cfg16, params32, params16, model, dev,
                    top1_rtol=None) -> float:
    """The Server in float32 on 3 requests of 48, 32 and 64 prompt tokens,
    16 new tokens each, 2 slots (`check_served` on both batches), then the
    decode ms per token at B = 2 (host clock over 20 steps after 3) and a
    profile of 5 steps; returns the decode ms."""
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.serving.engine import Request, Server
    rng = np.random.default_rng(LM_SEED + 2)
    prompts = [rng.integers(2, cfg32.vocab, n).astype(np.int32)
               for n in (48, 32, 64)]
    srv = Server(cfg32, model, params32, batch_slots=2, max_len=128, eos=-1)
    for i, pr in enumerate(prompts):
        srv.submit(Request(i, pr, max_new_tokens=16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if len(done) != 3 or any(len(r.out_tokens) != 16 for r in done):
        fail(f"Server {cfg32.name}: {[len(r.out_tokens) for r in done]} "
             f"tokens, want 16 for each of 3 requests")
    prefill32 = steps.make_prefill_step(cfg32, model)
    dec = steps.make_decode_step(cfg32, model)
    for batch in (done[:2], done[2:]):
        check_served(batch, params32, params16, cfg32, cfg16, prefill32,
                     dec, dev, model, top1_rtol)
    n_calls = srv.stats.decode_steps + sum(
        max(len(r.prompt) for r in b) for b in (done[:2], done[2:]))
    state = {"cache": model.init_cache(cfg32, 2, 128, torch.float32, dev),
             "t": 0}
    tok = torch.as_tensor([5, 7], device=dev)

    def one_step():
        _, state["cache"] = dec(params32, tok, state["cache"], state["t"])
        state["t"] += 1

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        one_step()
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / 20
    dec_profile = profile_device(one_step, "float32 decode step, B=2", 5)
    print(f"Server ({cfg32.name}, float32, {cfg32.n_layers} layers): 3 "
          f"requests, {srv.stats.tokens_out} tokens in {run_s:.2f} s over "
          f"{n_calls} decode_step calls ({run_s * 1e3 / n_calls:.1f} ms "
          f"each); decode ms per token at B=2: {dec_ms:.2f} ms")
    print(dec_profile)
    return dec_ms


def lm_phases(dev) -> list:
    """Phases 6-10 (the zamba2-1.2b serving slice); returns the flash and
    SSD rows of the `kernels` line."""
    import dataclasses
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import zamba2_1p2b
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss
    from repro_torch.launch import steps
    from repro_torch.models import mamba_lm
    from repro_torch.nn import core

    # float32 checks hold the kernels and the golden in full float32: no
    # TF32 in matrix products (the default; the port has no convolution)
    torch.backends.cuda.matmul.allow_tf32 = False

    # 6. kernels vs plain
    worst = check_lm_kernels(dev)

    # 7. main path: the bf16 prefill step at full width and depth
    base = zamba2_1p2b.config()
    cfg16 = dataclasses.replace(base, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
    cfg32 = dataclasses.replace(base, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    t0 = time.perf_counter()
    # `mamba_lm.init` on a seeded CPU generator: ~5x faster than the
    # single-threaded numpy stream the golden's weights come from
    params32 = mamba_lm.init(torch.Generator().manual_seed(LM_SEED), cfg32,
                             dev)
    gen_s = time.perf_counter() - t0
    params16 = cast_params(params32, torch.bfloat16)
    n_par = sum(t.numel() for t in _leaves(params16))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params16))
    print(f"zamba2-1.2b: {base.n_layers} layers, {n_par / 1e9:.3f} B "
          f"parameters ({cfg16.n_params / 1e9:.3f} B analytic), bf16 "
          f"{n_bytes / 1e9:.2f} GB; seeded weights (`mamba_lm.init`, a CPU "
          f"generator) in {gen_s:.1f} s")
    tokens = torch.as_tensor(np.random.default_rng(LM_SEED + 1).integers(
        0, base.vocab, (B_PREFILL, S_PREFILL)), device=dev)
    prefill16 = steps.make_prefill_step(cfg16, mamba_lm)
    want_flash = base.n_layers // base.attn_every
    want_ssd = base.n_layers * ss.kernel_launches(S_PREFILL)
    fa.LAUNCHES = 0
    ss.LAUNCHES = 0
    h = prefill16(params16, {"tokens": tokens})
    torch.cuda.synchronize()
    n_flash, n_ssd = fa.LAUNCHES, ss.LAUNCHES
    if (n_flash, n_ssd) != (want_flash, want_ssd):
        fail(f"prefill launched flash {n_flash} / SSD {n_ssd} times, want "
             f"{want_flash} / {want_ssd}")
    logits = core.unembed_logits(params16["embed"]["table"], h)
    if h.shape != (B_PREFILL, base.d_model) or not bool(
            torch.isfinite(h).all()) or not bool(
            torch.isfinite(logits).all()):
        fail(f"prefill: last hidden {tuple(h.shape)} or logits not finite")
    print(f"main path: zamba2-1.2b bf16 prefill B={B_PREFILL} "
          f"S={S_PREFILL}: flash launched {n_flash} times, SSD {n_ssd} "
          f"times; last hidden and logits {tuple(logits.shape)} finite")

    # 8. golden
    check_golden_lm(dev, "golden_zamba2.json", base, mamba_lm)

    # 9. the Server, float32, full width and depth
    serve_and_check(cfg32, cfg16, params32, params16, mamba_lm, dev)
    del params32

    # 10. timing (launches from here on are not the main path's)
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((B_PREFILL, S_PREFILL, 32, 64), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    flash = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    flash()
    flash_ms = cuda_ms(flash, 20)
    fa.flash_attention_plain(q, k, v, causal=True)
    flash_plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    lib_diff = float((sdpa().transpose(1, 2).float() - flash().float())
                     .abs().max())
    sdpa_ms = cuda_ms(sdpa, 20)
    f_bound, f_by = flash_bound(q, k, True, None)
    x = (0.5 * torch.randn((B_PREFILL, S_PREFILL, 64, 64), generator=gen,
                           device=dev)).to(torch.bfloat16)
    dt = F.softplus(torch.randn((B_PREFILL, S_PREFILL, 64), generator=gen,
                                device=dev))
    A = -torch.exp(0.3 * torch.randn(64, generator=gen, device=dev))
    Bm, Cm = ((0.3 * torch.randn((B_PREFILL, S_PREFILL, 1, 64),
                                 generator=gen, device=dev))
              .to(torch.bfloat16) for _ in range(2))
    scan = lambda: ss.ssd_scan(x, dt, A, Bm, Cm, chunk=64)  # noqa: E731
    scan()
    ssd_ms = cuda_ms(scan, 20)
    ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=64)
    ssd_plain_ms = cuda_ms(lambda: ss.ssd_scan_plain(x, dt, A, Bm, Cm,
                                                     chunk=64), 3)
    s_bound, s_by = ssd_bound(x, Bm, 64)
    s_states, s_reread = ssd_scratch_bytes(x, Bm)
    del q, k, v, qt, kt, vt, x, dt, Bm, Cm
    torch.cuda.reset_peak_memory_stats()
    pf = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill16(params16, {"tokens": tokens})
        torch.cuda.synchronize()
        pf.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pf_ms = float(np.mean(pf[1:]))
    print(f"flash kernel (B={B_PREFILL} S={S_PREFILL} H=32 Dh=64 causal "
          f"bf16): {flash_ms:.4f} ms; plain {flash_plain_ms:.3f} ms; "
          f"scaled_dot_product_attention {sdpa_ms:.4f} ms (max diff to the "
          f"kernel {lib_diff:.3g}); bound {f_bound:.5f} ms by {f_by}; "
          f"{n_flash} launches per prefill")
    print(f"ssd kernel (b={B_PREFILL} s={S_PREFILL} h=64 p=64 g=1 n=64 "
          f"bf16): {ssd_ms:.4f} ms; plain {ssd_plain_ms:.3f} ms; bound "
          f"{s_bound:.5f} ms by {s_by}; library call: none; {n_ssd} "
          f"launches per prefill ({ss.kernel_launches(S_PREFILL)} a call)")
    print(f"ssd split scratch traffic (a cost of the design, not in the "
          f"bound): {s_states / 1e6:.1f} MB of f32 group states, "
          f"{s_reread / 1e6:.1f} MB of x/B/dt re-read by launch 1; the "
          f"function's own traffic {s_bound * PEAK_BYTES_S / 1e9:.1f} MB")
    print(f"prefill (bf16, B={B_PREFILL} S={S_PREFILL}, {base.n_layers} "
          f"layers): "
          f"{pf_ms:.2f} ms mean of 3 after a warm call ("
          + ", ".join(f"{t:.2f}" for t in pf) + f" ms), "
          f"{B_PREFILL * S_PREFILL / pf_ms * 1e3:.0f} tokens/s; peak device "
          f"memory {peak_gb:.2f} GB")
    print(profile_device(lambda: prefill16(params16, {"tokens": tokens}),
                         f"bf16 prefill, B={B_PREFILL} S={S_PREFILL}"))
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:36",
             "launches": n_flash, "max_abs_err": worst["flash_attention"],
             "ms": flash_ms, "plain_ms": flash_plain_ms, "bound_ms": f_bound,
             "bound_by": f_by, "library_ms": sdpa_ms},
            {"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:28",
             "launches": n_ssd, "max_abs_err": worst["ssd_scan"],
             "ms": ssd_ms, "plain_ms": ssd_plain_ms, "bound_ms": s_bound,
             "bound_by": s_by, "library_ms": None}]


# relative RMS limits of a bf16 prefill through the flash kernel against
# the same prefill through `flash_attention_plain` (phase 16): every
# layer's attention output (one bf16 rounding apart on the first layer:
# ~1e-3), and the last hidden state, where a token whose top-k routing
# flips on a near tie moves a MoE arch's RMS by ~1/sqrt(tokens)
ATTN_RMS_LIMIT = 1e-2
HIDDEN_RMS_LIMIT = 5e-2
# bf16 moe_apply vs moe_apply_dense on the card: relative RMS (both round
# the same bf16 expert products; read 1.64e-5 moonshot-v1-16b-a3b, 1.35e-5
# dbrx-132b on an H100 80GB HBM3 at 700 W; one (token, slot) pair of the
# 1024 x k dropped or misweighted moves it by an estimated 1e-2)
MOE_RMS_LIMIT = 1e-4
TF_SEED = 3                     # torch.Generator seed of the new phases
TOP1_RTOL = 1e-5                # gemma3-4b's top-1 logit (its golden's)
OTHER_ARCHS = ("olmo-1b", "granite-3-2b", "yi-34b", "moonshot-v1-16b-a3b",
               "dbrx-132b")
OTHER_LAYERS = 2                # their depth cut (yi-34b whole ~68 GB bf16)


@contextlib.contextmanager
def flash_calls(plain: bool = False, keep: bool = False):
    """Record every call the model makes to the flash dispatch: dtype,
    head width, window, causal, Sq, Sk and (with `keep`) the output; with
    `plain`, serve each call by `flash_attention_plain` instead (no
    launch; autograd differentiates it)."""
    from repro_torch.kernels import flash_attention as fa
    real = fa.flash_attention
    calls = []

    def recorded(q, k, v, **kw):
        o = (fa.flash_attention_plain if plain else real)(q, k, v, **kw)
        calls.append({"dtype": q.dtype, "Dh": q.shape[-1],
                      "window": kw.get("window"),
                      "causal": kw.get("causal", True), "Sq": q.shape[1],
                      "Sk": k.shape[1], "out": o if keep else None})
        return o

    fa.flash_attention = recorded
    try:
        yield calls
    finally:
        fa.flash_attention = real


def cast_params(tree, dtype):
    """A parameter tree in `dtype`, the leaves the reference keeps in
    float32 (the MoE router; the SSD's A_log, D, dt_bias) left as they
    are."""
    from repro_torch.convert import F32_LEAVES
    return {k: cast_params(v, dtype) if isinstance(v, dict)
            else v if k in F32_LEAVES else v.to(dtype)
            for k, v in tree.items()}


def check_wide_flash(dev) -> float:
    """Phase 11: flash at gemma3-4b's and phi-3-vision's head widths
    against its plain version, float32 and bf16, with phase 6's
    tolerances; the bf16 rounding control on the causal shapes; returns
    the largest absolute error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        tol = LM_TOL[str(dtype)[6:]]
        for B, S, H, KvH, Dh, window in (
                (B_PREFILL, S_PREFILL, 8, 4, 256, None),      # gemma3 global
                (B_PREFILL, S_PREFILL, 8, 4, 256, 1024),      # gemma3 local
                (B_PREFILL, S_PREFILL, 32, 32, 96, None),     # phi-3-vision
                (1, 1100, 8, 4, 256, 1024),                   # ragged S
                (1, 1000, 32, 32, 96, None)):
            q = torch.randn((B, S, H, Dh), generator=gen, device=dev) \
                .to(dtype)
            k, v = (torch.randn((B, S, KvH, Dh), generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            err = hold(f"flash B={B} S={S} H={H} KvH={KvH} Dh={Dh} "
                       f"window={window} {str(dtype)[6:]}", got,
                       fa.flash_attention_plain(q, k, v, causal=True,
                                                window=window),
                       FLASH_BF16_ATOL if bf16 else tol,
                       FLASH_BF16_RTOL if bf16 else tol)
            worst = max(worst, err)
            if bf16 and S == S_PREFILL and window is None:
                check_flash_rounding(got, q, k, v)
            del q, k, v, got
    return worst


def time_wide_flash(dev) -> list:
    """Phase 17: bf16 flash ms (CUDA events, 20 calls) at gemma3-4b's
    global and local layers and phi-3-vision's, beside the plain
    version's (3 calls), `scaled_dot_product_attention`'s (a yardstick:
    the port never calls it) with the kernel that served it, and the
    bound; returns the rows."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for name, H, KvH, Dh, window in (("gemma3-4b global", 8, 4, 256, None),
                                     ("gemma3-4b local", 8, 4, 256, 1024),
                                     ("phi-3-vision", 32, 32, 96, None)):
        q = torch.randn((B_PREFILL, S_PREFILL, H, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B_PREFILL, S_PREFILL, KvH, Dh), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        flash = lambda: fa.flash_attention(  # noqa: E731
            q, k, v, causal=True, window=window)
        plain = lambda: fa.flash_attention_plain(  # noqa: E731
            q, k, v, causal=True, window=window)
        sdpa, backend = sdpa_call(q, k, v, True, window)
        flash()
        ms = cuda_ms(flash, 20)
        plain()
        plain_ms = cuda_ms(plain, 3)
        sdpa()
        sdpa_ms = cuda_ms(sdpa, 20)
        diff = float((sdpa().transpose(1, 2).float() - flash().float())
                     .abs().max())
        bound, by = flash_bound(q, k, True, window)
        rows.append((name, ms))
        print(f"flash kernel ({name}: B={B_PREFILL} S={S_PREFILL} H={H} "
              f"KvH={KvH} Dh={Dh} window={window} bf16): {ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms; scaled_dot_product_attention {sdpa_ms:.4f} "
              f"ms by its {backend} backend (max diff to the kernel "
              f"{diff:.3g}); "
              f"bound {bound:.5f} ms by {by}")
        del q, k, v
    return rows


def transformer_phases(dev) -> tuple:
    """Phases 11-17 (the transformer family's serving slice); returns
    (flash launches on its main paths, largest flash error)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import gemma3_4b, phi3_vision_4p2b
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import registry, transformer
    from repro_torch.nn import core, moe

    # 11. flash at the new head widths vs plain
    worst = check_wide_flash(dev)

    # 12. main path: gemma3-4b's bf16 prefill at full width and depth
    base = gemma3_4b.config()
    cfg32 = dataclasses.replace(base, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    cfg16 = dataclasses.replace(base, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params32 = transformer.init(torch.Generator().manual_seed(TF_SEED),
                                cfg32, dev)
    params16 = cast_params(params32, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"gemma3-4b: {base.n_layers} layers, "
          f"{core.count_params(params16) / 1e9:.3f} B parameters "
          f"({base.n_params / 1e9:.3f} B analytic), bf16 "
          f"{core.param_bytes(params16) / 1e9:.2f} GB; seeded weights "
          f"(a CPU torch.Generator, moved to the card) in {init_s:.1f} s")
    tokens = torch.randint(0, base.vocab, (B_PREFILL, S_PREFILL),
                           generator=torch.Generator(device=dev)
                           .manual_seed(TF_SEED + 1), device=dev)
    prefill16 = steps.make_prefill_step(cfg16, transformer)
    flags = transformer.layer_flags(base)
    n_local = sum(w < transformer.BIG_WINDOW for w in flags["window"])
    fa.LAUNCHES = 0
    with flash_calls() as calls:
        h, cache = prefill16(params16, {"tokens": tokens})
    torch.cuda.synchronize()
    n_gemma = fa.LAUNCHES
    windows = [c["window"] for c in calls]
    if n_gemma != base.n_layers or \
            windows.count(base.window) != n_local or \
            windows.count(None) != base.n_layers - n_local or \
            {(c["dtype"], c["Dh"]) for c in calls} != {(torch.bfloat16,
                                                        base.head_dim)}:
        fail(f"gemma3-4b prefill launched flash {n_gemma} times with windows "
             f"{windows}, want {base.n_layers}: {n_local} x {base.window}, "
             f"the rest none, all bf16 at Dh {base.head_dim}")
    logits = core.unembed_logits(params16["embed"]["table"], h)
    want_cache = (base.n_layers, B_PREFILL, S_PREFILL, base.n_kv_heads,
                  base.head_dim)
    if h.shape != (B_PREFILL, base.d_model) or tuple(cache["k"].shape) != \
            want_cache or not bool(torch.isfinite(h).all()) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"gemma3-4b prefill: last hidden {tuple(h.shape)}, cache "
             f"{tuple(cache['k'].shape)} or logits not finite")
    print(f"main path: gemma3-4b bf16 prefill B={B_PREFILL} S={S_PREFILL}: "
          f"flash launched {n_gemma} times ({windows.count(base.window)} with "
          f"window {base.window}, {windows.count(None)} without), all bf16 "
          f"Dh {base.head_dim}; last hidden, KV cache {want_cache} and logits "
          f"{tuple(logits.shape)} finite")
    del h, cache, logits, calls

    # 13. golden: 6 layers in float32 against the JAX reference
    check_golden_lm(dev, "golden_gemma3.json", base, transformer)

    # 14. the Server at full width and depth, float32
    dec_ms = serve_and_check(cfg32, cfg16, params32, params16, transformer,
                             dev, TOP1_RTOL)
    del params32

    # 17 (first part, on these weights): prefill ms, tokens/s, memory
    torch.cuda.reset_peak_memory_stats()
    pf = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill16(params16, {"tokens": tokens})
        torch.cuda.synchronize()
        pf.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pf_ms = float(np.mean(pf[1:]))
    flops = prefill_flops(base, B_PREFILL, S_PREFILL)
    prefill_line = (
        f"gemma3-4b prefill (bf16, B={B_PREFILL} S={S_PREFILL}, "
        f"{base.n_layers} layers): {pf_ms:.2f} ms mean of 3 after a warm call"
        f" (" + ", ".join(f"{t:.2f}" for t in pf) + f" ms), "
        f"{B_PREFILL * S_PREFILL / pf_ms * 1e3:.0f} tokens/s; "
        f"{flops / 1e12:.2f} TFLOP of products, bound "
        f"{flops / PEAK_BF16_OPS_S * 1e3:.2f} ms at the bf16 peak "
        f"({flops / PEAK_BF16_OPS_S * 1e3 / pf_ms * 100:.1f} % of it "
        f"reached); "
        f"peak device memory {peak_gb:.2f} GB; Server decode {dec_ms:.2f} ms "
        f"a token")
    prefill_profile = profile_device(
        lambda: prefill16(params16, {"tokens": tokens}),
        f"gemma3-4b bf16 prefill, B={B_PREFILL} S={S_PREFILL}",
        tags=("flash_kernel",))
    del params16, tokens

    # 15. phi-3-vision at full width and depth, 576 vision embeddings
    cfg = dataclasses.replace(phi3_vision_4p2b.config(),
                              param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(TF_SEED + 2)
    params = transformer.init(gen, cfg, dev)
    inputs = {"tokens": torch.randint(0, cfg.vocab, (B_PREFILL, S_PREFILL),
                                      generator=gen).to(dev),
              "vision_embeds": torch.randn(
                  (B_PREFILL, cfg.vision_tokens, cfg.vision_embed_dim),
                  generator=gen).to(dev)}
    fa.LAUNCHES = 0
    with flash_calls() as calls:
        h, cache = steps.make_prefill_step(cfg, transformer)(params, inputs)
    torch.cuda.synchronize()
    n_phi = fa.LAUNCHES
    if n_phi != cfg.n_layers or {(c["dtype"], c["Dh"], c["window"])
                                 for c in calls} != {(torch.bfloat16,
                                                      cfg.head_dim, None)}:
        fail(f"phi-3-vision prefill launched flash {n_phi} times, want "
             f"{cfg.n_layers}, all bf16 at Dh {cfg.head_dim} without a "
             f"window")
    logits = core.unembed_logits(params["embed"]["table"], h)
    if not bool(torch.isfinite(h).all()) or \
            not bool(torch.isfinite(logits).all()):
        fail("phi-3-vision prefill: last hidden or logits not finite")
    print(f"phi-3-vision-4.2b: {core.count_params(params) / 1e9:.3f} B "
          f"parameters ({cfg.n_params / 1e9:.3f} B analytic); bf16 prefill "
          f"B={B_PREFILL} S={S_PREFILL} with {cfg.vision_tokens} vision "
          f"embeddings: flash launched {n_phi} times at Dh {cfg.head_dim}; "
          f"last hidden "
          f"and logits finite")
    del params, inputs, h, cache, logits, calls

    # 16. the five other archs at full width, depth cut, kernel vs plain
    n_other = 0
    for arch in OTHER_ARCHS:
        full, model = registry.get(arch)
        cfg = dataclasses.replace(full, n_layers=OTHER_LAYERS,
                                  param_dtype=torch.bfloat16,
                                  compute_dtype=torch.bfloat16)
        gen = torch.Generator().manual_seed(TF_SEED + 3)
        params = model.init(gen, cfg, dev)
        tokens = torch.randint(0, cfg.vocab, (1, S_PREFILL),
                               generator=gen).to(dev)
        step = steps.make_prefill_step(cfg, model)
        fa.LAUNCHES = 0
        with flash_calls(keep=True) as kcalls:
            h, _ = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        launched = fa.LAUNCHES
        n_other += launched
        with flash_calls(plain=True, keep=True) as pcalls:
            h_plain, _ = step(params, {"tokens": tokens})
        if launched != cfg.n_layers or fa.LAUNCHES != launched:
            fail(f"{arch}: flash launched {launched} times through the "
                 f"kernel, {fa.LAUNCHES - launched} through the plain "
                 f"version, want {cfg.n_layers} and 0")
        attn = max(rel_rms(a["out"], b["out"]) for a, b in zip(kcalls,
                                                               pcalls))
        hid = rel_rms(h, h_plain)
        if not bool(torch.isfinite(h).all()) or attn > ATTN_RMS_LIMIT or \
                hid > HIDDEN_RMS_LIMIT:
            miss(f"{arch}: kernel vs plain prefill, attention rel RMS {attn} "
                 f"(limit {ATTN_RMS_LIMIT}), last hidden {hid} (limit "
                 f"{HIDDEN_RMS_LIMIT})")
        line = (f"{arch} ({OTHER_LAYERS} of {full.n_layers} layers, full "
                f"width, {core.count_params(params) / 1e9:.2f} B parameters)"
                f": bf16 prefill B=1 S={S_PREFILL}, {launched} flash launches "
                f"(Dh {cfg.head_dim}); through the kernel vs through the "
                f"plain version: attention outputs rel RMS {attn:.3g} (limit "
                f"{ATTN_RMS_LIMIT:g}), last hidden {hid:.3g} (limit "
                f"{HIDDEN_RMS_LIMIT:g})")
        del kcalls, pcalls, h, h_plain
        if cfg.n_experts:
            line += "; " + check_moe(params, cfg, dev)
        print(line)
        del params
        torch.cuda.empty_cache()

    # 17. timing of the new shapes
    time_wide_flash(dev)
    print(prefill_line)
    print(prefill_profile)
    return n_gemma + n_phi + n_other, worst


def prefill_flops(cfg, B: int, S: int) -> float:
    """Products of one transformer prefill (2 flops a multiply-add): every
    token through each layer's projections and MLP (or its top-k
    experts), each layer's q.k and p.v over the keys its mask leaves
    (causal, and its window on a local layer), and the last position's
    unembedding."""
    from repro_torch.models import transformer
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_token = D * (H + 2 * K) * Dh + H * Dh * D + 3 * D * F * max(
        cfg.top_k, 1) + (D * cfg.n_experts if cfg.n_experts else 0)
    pairs = 0
    for w in transformer.layer_flags(cfg)["window"]:
        w = min(w, S)
        pairs += w * (w + 1) // 2 + (S - w) * w
    return 2.0 * B * S * L * per_token + 4.0 * B * H * Dh * pairs + \
        2.0 * B * D * cfg.vocab


def check_moe(params, cfg, dev) -> str:
    """`moe_apply` against `moe_apply_dense` on layer 0's experts at full
    width, on 1024 tokens drawn N(0, 1) like a normalised hidden state:
    in bf16 within MOE_RMS_LIMIT relative RMS, in float32 (the same
    weights) within 1e-5 of the largest output; the card's expert ids
    equal to the CPU's `_route` on the same input, up to ties within
    1e-6 in probability."""
    import torch
    from repro_torch.nn import moe
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn((1, 1024, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    ya, _ = moe.moe_apply(p, x.bfloat16(), cfg.top_k)
    yd, _ = moe.moe_apply_dense(p, x.bfloat16(), cfg.top_k)
    err16 = rel_rms(ya, yd)
    p32 = {k: v.float() for k, v in p.items()}
    ya32, _ = moe.moe_apply(p32, x, cfg.top_k)
    yd32, _ = moe.moe_apply_dense(p32, x, cfg.top_k)
    err32 = float((ya32 - yd32).abs().max() / yd32.abs().max())
    _, ids, probs = moe._route(x[0], p["router"], cfg.top_k)
    _, ids_cpu, _ = moe._route(x[0].cpu(), p["router"].cpu(), cfg.top_k)
    ids, probs = ids.cpu(), probs.cpu()
    differ = (ids != ids_cpu).any(dim=-1)
    # where the ids differ, the two choices' probabilities must tie
    tied = bool(((probs.gather(1, ids) - probs.gather(1, ids_cpu))[differ]
                 .abs() <= 1e-6).all())
    if err16 > MOE_RMS_LIMIT or err32 > 1e-5 or not tied:
        miss(f"{cfg.name}: moe_apply vs moe_apply_dense rel RMS {err16} "
             f"(limit {MOE_RMS_LIMIT}), float32 {err32} (limit 1e-5); "
             f"expert ids differ from the CPU's on {int(differ.sum())} "
             f"tokens, ties {tied}")
    return (f"moe_apply vs moe_apply_dense (layer 0, 1024 tokens, "
            f"{cfg.n_experts} experts top-{cfg.top_k}): bf16 rel RMS "
            f"{err16:.3g} (limit {MOE_RMS_LIMIT:g}), float32 max err "
            f"{err32:.3g} of the largest output (limit 1e-5); expert ids "
            f"equal to the CPU's on {1024 - int(differ.sum())} of 1024 "
            f"tokens (the rest tied within 1e-6: {tied})")


# ---------------------------------------------------------------------------
# phases 18-22: the training path and whisper-medium
# ---------------------------------------------------------------------------

# flash backward shapes (name, B, Sq, Sk, H, KvH, Dh, causal, window): a
# training step's attention at olmo-1b's heads, whisper's encoder and
# cross-attention, gemma3-4b's global and local layers (GQA 2:1, Dh 256),
# phi-3-vision's (Dh 96) and zamba2-1.2b's shared block at phase 24's
# step (B 4 x S 2048, Dh 64)
BWD_SHAPES = (("olmo-1b", 2, 2048, 2048, 16, 16, 128, True, None),
              ("whisper encoder", 2, 1500, 1500, 16, 16, 64, False, None),
              ("whisper cross", 2, 448, 1500, 16, 16, 64, False, None),
              ("gemma3-4b global", 1, 2048, 2048, 8, 4, 256, True, None),
              ("gemma3-4b local", 1, 2048, 2048, 8, 4, 256, True, 1024),
              ("phi-3-vision", 1, 2048, 2048, 32, 32, 96, True, None),
              ("zamba2-1.2b shared block", 4, 2048, 2048, 32, 32, 64, True,
               None))
# float32 dq / dk / dv against autograd of `flash_attention_plain`: max
# abs error over the gradient's largest magnitude (3.7e-6 the worst read
# at these shapes on an H100 80GB HBM3 at 700 W: float32 sums in another
# order)
BWD_F32_REL = 1e-5
# bf16 against the plain version's bf16 run: one bf16 spacing at the
# gradient's largest magnitude (2^-7 of it) on each side, since the plain
# run rounds dP to bf16 before its float32 sums where the kernel keeps
# float32 (the two sit on either side of the exact value: 4e-3 to 6.5e-3
# of the largest magnitude read at these shapes on an H100 80GB HBM3 at
# 700 W), and a relative RMS error under half a spacing (2.7e-3 read)
BWD_BF16_MAX, BWD_BF16_RMS = 2.0 ** -6, 2.0 ** -8
TRAIN_ARCH = "olmo-1b"
TRAIN_B, TRAIN_S = 4, 2048
TRAIN_STEPS, RESUME_STEPS = 6, 2
# bf16 compute through the kernel vs through the plain attention, first
# step: relative differences of the loss and the gradient norm
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 5e-3, 5e-2
# card vs CPU, float32, one make_train_step: loss, per-leaf gradient
# relative RMS (read from the optimizer's first moment, (1 - b1) x the
# clipped gradient)
XDEV_LOSS_RTOL, XDEV_GRAD_RMS = 1e-5, 1e-4
WHISPER_S = 448                 # Whisper's text context (n_text_ctx)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def attn_pairs(Sq: int, Sk: int, causal: bool, window) -> float:
    """(query, key) pairs the masks leave."""
    import numpy as np
    qi = np.arange(Sq)
    hi = np.minimum(qi, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qi - window + 1) if window is not None else 0 * qi
    return float(np.clip(hi - lo + 1, 0, None).sum())


def flash_bwd_bound(q, k, causal: bool, window) -> tuple:
    """Bound of one attention backward: q, k, v, o, dO and the row lse
    read once, dq, dk, dv written once; 2.5 x the forward's products (dV,
    dP, dQ, dK and the recomputed S: FlashAttention-2's count)."""
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    elt = q.element_size()
    n_bytes = (5 * B * Sq * H + 4 * B * Sk * KvH) * Dh * elt + 4 * B * H * Sq
    ops = 2.5 * 4.0 * B * H * Dh * attn_pairs(Sq, Sk, causal, window)
    return _bound(n_bytes, ops, str(q.dtype)[6:])


def autograd_plain(q, k, v, do, causal, window):
    """dq, dk, dv by autograd of `flash_attention_plain`."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(o, (q, k, v), do)


def bits_equal(a, b) -> bool:
    """Same shape, dtype and bits (NaNs included)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.contiguous(), b.contiguous()
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return torch.equal(a.view(width[a.element_size()]),
                           b.view(width[b.element_size()]))
    return torch.equal(a, b)


def check_flash_bwd(dev) -> float:
    """Phase 18: the backward kernel, through the autograd function, vs
    autograd of the plain forward at BWD_SHAPES in float32 (BWD_F32_REL)
    and bf16 (BWD_BF16_MAX / BWD_BF16_RMS, with a control: the bf16
    gradients against the float32 ones must miss BWD_F32_REL), and a
    second run through the function bit for bit equal to the first;
    returns the largest abs error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, Sq, Sk, H, KvH, Dh, causal, window in BWD_SHAPES:
            q, do = (torch.randn((B, Sq, H, Dh), generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((B, Sk, KvH, Dh), generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            runs = []
            for _ in range(2):
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
                fa.flash_attention(qg, kg, vg, causal=causal,
                                   window=window).backward(do)
                if (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) != (1, 1):
                    fail(f"flash bwd {name}: {fa.LAUNCHES - f0} forward / "
                         f"{fa.BWD_LAUNCHES - b0} backward launches, want "
                         f"1 / 1")
                runs.append((qg.grad, kg.grad, vg.grad))
            got = runs[0]
            torch.cuda.synchronize()
            if not all(bits_equal(a, b) for a, b in zip(*runs)):
                fail(f"flash bwd {name} {str(dtype)[6:]}: a second run's "
                     f"gradients differ from the first's")
            want = autograd_plain(q, k, v, do, causal, window)
            torch.cuda.synchronize()
            label = (f"flash bwd {name} B={B} Sq={Sq} Sk={Sk} H={H} "
                     f"KvH={KvH} Dh={Dh} causal={causal} window={window} "
                     f"{str(dtype)[6:]}")
            rels = []
            for g, a, b in zip("qkv", got, want):
                if a.dtype != dtype or not bool(torch.isfinite(a).all()):
                    fail(f"{label}: d{g} not finite or not {dtype}")
                a, b = a.float(), b.float()
                top = float(b.abs().max())
                err = float((a - b).abs().max())
                worst = max(worst, err)
                rels.append(err / top)
                if dtype == torch.float32 and err > BWD_F32_REL * top:
                    miss(f"{label}: d{g} off autograd of the plain version "
                         f"by {err / top:.3g} of its largest magnitude (tol "
                         f"{BWD_F32_REL:g})")
                if dtype == torch.bfloat16 and (
                        err > BWD_BF16_MAX * top or
                        rel_rms(a, b) > BWD_BF16_RMS):
                    miss(f"{label}: d{g} off the plain version's bf16 run "
                         f"by {err / top:.3g} of its largest magnitude (tol "
                         f"{BWD_BF16_MAX:g}), rel RMS {rel_rms(a, b):.3g} "
                         f"(tol {BWD_BF16_RMS:g})")
            line = (f"{label}: dq/dk/dv vs autograd of the plain version, "
                    f"max err / max |.| " + "/".join(f"{r:.3g}" for r in rels)
                    + "; a second run bit-equal")
            if dtype == torch.bfloat16:
                ref = autograd_plain(q.float(), k.float(), v.float(),
                                     do.float(), causal, window)
                ctrl = min(float((a.float() - b).abs().max()
                                 / b.abs().max()) for a, b in zip(got, ref))
                if ctrl <= BWD_F32_REL:
                    miss(f"{label}: the bf16 gradients are within the float32 "
                         f"tolerance of the float32 ones ({ctrl:.3g}): the "
                         f"tolerances do not tell the precisions apart")
                line += (f" (tol {BWD_BF16_MAX:g}; rel RMS "
                         + "/".join(f"{rel_rms(a, b):.3g}"
                                    for a, b in zip(got, want))
                         + f", tol {BWD_BF16_RMS:g}); control: vs the "
                         f"float32 gradients {ctrl:.3g} > {BWD_F32_REL:g}")
            else:
                line += f" (tol {BWD_F32_REL:g})"
            print(line)
            del q, k, v, do, qg, kg, vg, got, want, runs
    return worst


def time_flash_bwd(dev) -> list:
    """Phase 22's kernel times: at each BWD_SHAPES entry in bf16, the
    backward kernel alone (CUDA events, 10 calls, on the forward kernel's
    own o and lse), the plain version `flash_attention_bwd_plain` (2
    calls), scaled_dot_product_attention's backward (10 calls; a
    yardstick, the port never calls it) and the bound; returns the rows
    (name, ms, plain ms, bound, bound_by, sdpa backward ms)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for name, B, Sq, Sk, H, KvH, Dh, causal, window in BWD_SHAPES:
        q, do = (torch.randn((B, Sq, H, Dh), generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Sk, KvH, Dh), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa._flash_cuda(q, k, v, causal=causal, window=window,
                                lse=True)
        bwd = lambda: fa._flash_bwd_cuda(  # noqa: E731
            q, k, v, o, do, lse, causal=causal, window=window)
        bwd()
        ms = cuda_ms(bwd, 10)
        plain = lambda: fa.flash_attention_bwd_plain(  # noqa: E731
            q, k, v, o, do, lse, causal=causal, window=window)
        plain()
        plain_ms = cuda_ms(plain, 2)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa, backend = sdpa_call(qs, ks, vs, causal, window)
        o_s = sdpa()
        do_t = do.transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            o_s, (qs, ks, vs), do_t, retain_graph=True)
        sdpa_bwd()
        sdpa_ms = cuda_ms(sdpa_bwd, 10)
        bound, by = flash_bwd_bound(q, k, causal, window)
        rows.append((name, ms, plain_ms, bound, by, sdpa_ms))
        print(f"flash bwd kernel ({name}: B={B} Sq={Sq} Sk={Sk} H={H} "
              f"KvH={KvH} Dh={Dh} causal={causal} window={window} bf16): "
              f"{ms:.4f} ms; plain {plain_ms:.3f} ms; "
              f"scaled_dot_product_attention backward {sdpa_ms:.4f} ms by "
              f"its {backend} backend; bound {bound:.5f} ms by {by} "
              f"({bound / ms * 100:.1f} % of it reached)")
        del q, k, v, do, o, lse, qs, ks, vs, o_s
    return rows


def train_flops(cfg, B: int, S: int) -> float:
    """Products of one training step (2 flops a multiply-add): 6 x
    parameters x tokens (forward, and the backward's two products per
    weight) plus the attention's, 3.5 x the forward's q.k and p.v (the
    forward and the backward's 2.5 x), each layer over the (query, key)
    pairs its own window leaves (`transformer.layer_flags`)."""
    from repro_torch.models import transformer
    pairs = sum(attn_pairs(S, S, True, None if w >= transformer.BIG_WINDOW
                           else w)
                for w in transformer.layer_flags(cfg)["window"])
    return 6.0 * cfg.n_params * B * S + \
        3.5 * 4.0 * B * cfg.n_heads * cfg.head_dim * pairs


def grad_checks(label: str, grads, attn_keys) -> None:
    """Every gradient leaf finite, and the attention projections' wq /
    wk / wv of every layer nonzero (the flash kernel's output carries a
    gradient): `attn_keys` are the (layer stack, attention) keys."""
    import torch
    from repro_torch import tree
    bad = [i for i, g in enumerate(tree.leaves(grads))
           if not bool(torch.isfinite(g).all())]
    if bad:
        fail(f"{label}: gradient leaves {bad} not finite")
    for stack, attn in attn_keys:
        for w in ("wq", "wk", "wv"):
            g = grads[stack][attn][w]
            zero = [i for i in range(g.shape[0])
                    if not bool((g[i] != 0).any())]
            if zero:
                fail(f"{label}: {stack}.{attn}.{w} has no gradient on layers "
                     f"{zero}: the attention output dropped it")


def grads_vs_plain(label, loss_of, params, n_fwd, n_bwd, attn_keys,
                   plain_loss_of=None) -> tuple:
    """The loss and gradients of `loss_of` through the kernels (forward and
    backward launches counted: `n_fwd`, `n_bwd` wanted), every gradient
    checked (`grad_checks`), and again through `flash_attention_plain`
    (by `plain_loss_of` where given: the same loss under remat); returns
    (loss, grad norm, plain loss, plain grad norm)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as opt
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    loss, grads = steps.value_and_grad(loss_of, params)
    torch.cuda.synchronize()
    counts = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    if counts != (n_fwd, n_bwd):
        fail(f"{label}: flash launched {counts[0]} forward / {counts[1]} "
             f"backward, want {n_fwd} / {n_bwd}")
    grad_checks(label, grads, attn_keys)
    gnorm = float(opt.global_norm(grads))
    del grads
    with flash_calls(plain=True):
        loss_p, grads_p = steps.value_and_grad(plain_loss_of or loss_of,
                                               params)
    gnorm_p = float(opt.global_norm(grads_p))
    del grads_p
    loss, loss_p = float(loss), float(loss_p)
    if not (abs(loss - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p) and
            abs(gnorm - gnorm_p) <= TRAIN_GNORM_RTOL * gnorm_p):
        miss(f"{label}: through the kernels loss {loss} grad norm {gnorm}, "
             f"through the plain attention {loss_p} / {gnorm_p} (rtol "
             f"{TRAIN_LOSS_RTOL:g} / {TRAIN_GNORM_RTOL:g})")
    print(f"{label}: {counts[0]} forward + {counts[1]} backward flash "
          f"launches; every gradient finite, wq / wk / wv nonzero on every "
          f"layer; loss {loss:.6f} vs {loss_p:.6f} through the plain "
          f"attention (rel {abs(loss - loss_p) / abs(loss_p):.3g}, tol "
          f"{TRAIN_LOSS_RTOL:g}), grad norm {gnorm:.6g} vs {gnorm_p:.6g} "
          f"(rel {abs(gnorm - gnorm_p) / gnorm_p:.3g}, tol "
          f"{TRAIN_GNORM_RTOL:g})")
    return loss, gnorm, loss_p, gnorm_p


def train_olmo(dev) -> tuple:
    """Phase 19: olmo-1b at full width and depth (16 layers, float32
    parameters, bf16 compute), B = TRAIN_B x S = TRAIN_S: the first
    step's loss and gradients through the kernels vs the plain attention
    (`grads_vs_plain`, without remat: 16 + 16 launches); `train()` for
    TRAIN_STEPS AdamW steps with a checkpoint at the end, the checkpoint
    restored bit for bit, `train()` resumed from it for RESUME_STEPS more
    (16 forward and 16 backward launches each step, every loss and grad
    norm finite), then one step with int8 gradient compression; returns
    (forward launches, backward launches, the timing line, the train
    step's profile)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train
    from repro_torch.models import registry, transformer
    from repro_torch.nn import core
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    cfg, _ = registry.get(TRAIN_ARCH)
    L = cfg.n_layers
    # `train`'s own weights (seed 0)
    params = transformer.init(torch.Generator().manual_seed(0), cfg, dev)
    print(f"{TRAIN_ARCH} training: {L} layers, "
          f"{core.count_params(params) / 1e9:.3f} B parameters "
          f"({cfg.param_dtype} parameters, {cfg.compute_dtype} compute), "
          f"B={TRAIN_B} S={TRAIN_S}")
    batch = lm_batch(DataConfig(cfg.vocab, TRAIN_S, TRAIN_B), 0, dev)
    grads_vs_plain(f"{TRAIN_ARCH} first step", lambda p: transformer.loss_fn(
        p, cfg, batch, remat=False), params, L, L, (("layers", "attn"),))

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    rec = {"t": None, "rows": []}

    def on_step(s, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["rows"].append((s, float(m["loss"]), float(m["grad_norm"]),
                            fa.LAUNCHES, fa.BWD_LAUNCHES,
                            (now - rec["t"]) * 1e3))
        fa.LAUNCHES = fa.BWD_LAUNCHES = 0
        rec["t"] = time.perf_counter()

    kw = dict(smoke=False, batch=TRAIN_B, seq=TRAIN_S, device=dev,
              ckpt_dir=str(CKPT_DIR), ckpt_every=TRAIN_STEPS, log_every=1,
              on_step=on_step)
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    rec["t"] = time.perf_counter()
    p6, losses = train.train(TRAIN_ARCH, steps=TRAIN_STEPS, **kw)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if ckpt.latest_step(CKPT_DIR) != TRAIN_STEPS:
        fail(f"train: no checkpoint at step {TRAIN_STEPS}")
    t0 = time.perf_counter()
    like = (params, opt.init(params))
    (restored, _), _ = ckpt.restore(CKPT_DIR, like)
    restore_s = time.perf_counter() - t0
    from repro_torch import tree
    if not all(torch.equal(a, b) for a, b in zip(tree.leaves(restored),
                                                 tree.leaves(p6))):
        fail("train: the restored checkpoint differs from the trained "
             "parameters")
    del restored, like, p6
    rec["t"] = time.perf_counter()
    _, more = train.train(TRAIN_ARCH, steps=TRAIN_STEPS + RESUME_STEPS, **kw)
    if len(losses) != TRAIN_STEPS or len(more) != RESUME_STEPS:
        fail(f"train: {len(losses)} + {len(more)} steps, want {TRAIN_STEPS} "
             f"+ {RESUME_STEPS} (resumed from step {TRAIN_STEPS})")
    rows = rec["rows"]
    for s, loss, gn, nf, nb, _ in rows:
        if not (np.isfinite(loss) and np.isfinite(gn)) or (nf, nb) != (L, L):
            fail(f"train step {s}: loss {loss}, grad norm {gn}, flash "
                 f"{nf} forward / {nb} backward launches (want {L} / {L})")
    rec["rows"] = []
    rec["t"] = time.perf_counter()
    _, closs = train.train(TRAIN_ARCH, steps=1, compress_grads=True,
                           **{**kw, "ckpt_dir": None})
    (_, _, cgn, cf, cb, _), = rec["rows"]
    if not (np.isfinite(closs[0]) and np.isfinite(cgn)) or (cf, cb) != (L, L):
        fail(f"train with compress_grads: loss {closs}, grad norm {cgn}, "
             f"flash {cf} / {cb} launches")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    step_ms = [r[5] for r in rows[1:TRAIN_STEPS]]
    ms = float(np.mean(step_ms))
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    line = (f"{TRAIN_ARCH} train() (bf16 compute, B={TRAIN_B} S={TRAIN_S}, "
            f"{L} layers): losses "
            + ", ".join(f"{r[1]:.4f}" for r in rows)
            + " (steps 0-5, resumed 6-7); grad norms "
            + ", ".join(f"{r[2]:.4g}" for r in rows)
            + f"; {L} + {L} flash launches every step; compressed step loss "
            f"{closs[0]:.4f}; ms per step {ms:.1f} (mean of steps 1-5: "
            + ", ".join(f"{t:.1f}" for t in step_ms) + f"; step 0 "
            f"{rows[0][5]:.1f}), {TRAIN_B * TRAIN_S / ms * 1e3:.0f} "
            f"tokens/s; {flops / 1e12:.1f} TFLOP of products a step, "
            f"{flops / (ms * 1e-3) / PEAK_BF16_OPS_S * 100:.1f} % of the bf16 "
            f"peak; peak device memory {peak_gb:.2f} GB; checkpoint restore "
            f"{restore_s:.1f} s")
    step = steps.make_train_step(cfg, transformer)
    state = opt.init(params)
    prof = profile_device(lambda: step(params, state, batch),
                          f"{TRAIN_ARCH} make_train_step (remat), "
                          f"B={TRAIN_B} S={TRAIN_S}",
                          tags=("flash_kernel", "flash_bwd"))
    # the first step, the trained and resumed steps, the compressed step
    n = L * (1 + TRAIN_STEPS + RESUME_STEPS + 1)
    return n, n, line, prof


def train_card_vs_cpu(dev) -> tuple:
    """Phase 20: olmo-1b at full width, 2 layers, float32, B = 1 x S = 512:
    one `make_train_step` (remat: each layer's forward runs again in the
    backward) from the same numpy weights on the card and on the CPU;
    loss within XDEV_LOSS_RTOL, each gradient leaf (the first moment /
    (1 - b1)) within XDEV_GRAD_RMS relative RMS, updated parameters
    within 2.1 x the step's lr (a near-zero gradient's sign may differ,
    and Adam's first step moves a parameter by about lr x its sign);
    returns the card's (forward, backward) flash launches."""
    import dataclasses
    import torch
    from repro_torch import convert, tree
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import registry, transformer
    from repro_torch.training import optimizer as opt
    full, _ = registry.get(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    t0 = time.perf_counter()
    np_tree = convert.lm_params_numpy(cfg, LM_SEED)
    batch = lm_batch(DataConfig(cfg.vocab, 512, 1), 0, "cpu")
    step = steps.make_train_step(cfg, transformer)
    out = []
    for d in (dev, torch.device("cpu")):
        params = convert.lm_params_from_numpy(np_tree, cfg, d)
        fa.LAUNCHES = fa.BWD_LAUNCHES = 0
        p, o, m = step(params, opt.init(params),
                       {k: v.to(d) for k, v in batch.items()})
        out.append((p, o, m, (fa.LAUNCHES, fa.BWD_LAUNCHES)))
    (pc, oc, mc, counts), (pp, op, mp, _) = out
    loss, loss_cpu = float(mc["loss"]), float(mp["loss"])
    rms = max(rel_rms(a.cpu(), b) for a, b in zip(tree.leaves(oc["m"]),
                                                  tree.leaves(op["m"])))
    lr = float(mp["lr"])
    dp = max(float((a.cpu() - b).abs().max()) for a, b in
             zip(tree.leaves(pc), tree.leaves(pp)))
    if counts != (2 * cfg.n_layers, cfg.n_layers) or \
            abs(loss - loss_cpu) > XDEV_LOSS_RTOL * abs(loss_cpu) or \
            rms > XDEV_GRAD_RMS or dp > 2.1 * lr:
        miss(f"{TRAIN_ARCH} f32 train step, card vs CPU: launches {counts} "
             f"(want {(2 * cfg.n_layers, cfg.n_layers)}), loss {loss} vs "
             f"{loss_cpu}, gradient rel RMS {rms} (limit {XDEV_GRAD_RMS}), "
             f"updated parameters {dp} apart (limit 2.1 x lr {lr})")
    print(f"{TRAIN_ARCH} f32 make_train_step, 2 layers full width, B=1 "
          f"S=512, card vs CPU ({time.perf_counter() - t0:.1f} s): {counts[0]} "
          f"forward ({cfg.n_layers} recomputed) + {counts[1]} backward flash "
          f"launches; loss {loss:.7f} vs {loss_cpu:.7f} (rel "
          f"{abs(loss - loss_cpu) / abs(loss_cpu):.3g}, tol "
          f"{XDEV_LOSS_RTOL:g}); worst per-leaf gradient rel RMS {rms:.3g} "
          f"(tol {XDEV_GRAD_RMS:g}); grad norm {float(mc['grad_norm']):.6g} "
          f"vs {float(mp['grad_norm']):.6g}; updated parameters max "
          f"{dp:.3g} apart (lr {lr:.3g}, tol 2.1 lr)")
    return counts


def whisper_phases(dev) -> tuple:
    """Phase 21: whisper-medium at full width.  a. a bf16 prefill at full
    depth (24 + 24 layers), B = 2, decoder S = WHISPER_S against 1500
    frames: 72 flash launches (24 bidirectional over the frames, 24
    causal, 24 cross-attention), finite outputs, ms and tokens/s; b. the
    float32 golden at 4 + 4 layers (bf16 control); c. float32 at full
    depth, B = 1: 3 decode steps on the prefilled cache against the
    teacher-forced forward (DEC_ATOL_REL x the spread; the bf16 forward
    must miss); d. one train step at 2 + 2 layers through the backward
    kernel vs the plain attention (6 + 6 launches).  Returns (forward
    launches of a, c and d, backward launches of d)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import whisper_medium
    from repro_torch.golden import spread
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train
    from repro_torch.models import whisper
    from repro_torch.nn import core
    from repro_torch.data.pipeline import DataConfig, lm_batch
    base = whisper_medium.config()
    L, F = base.n_layers, base.audio_frames
    cfg16 = dataclasses.replace(base, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(TF_SEED + 5)
    params16 = whisper.init(gen, cfg16, dev)
    inputs = {"tokens": torch.randint(0, base.vocab, (B_PREFILL, WHISPER_S),
                                      generator=gen).to(dev),
              "frames": torch.randn((B_PREFILL, F, base.d_model),
                                    generator=gen).to(dev)}
    prefill16 = steps.make_prefill_step(cfg16, whisper)
    fa.LAUNCHES = 0
    with flash_calls() as calls:
        h, cache = prefill16(params16, inputs)
    torch.cuda.synchronize()
    n_pre = fa.LAUNCHES
    kinds = [(c["causal"], c["Sq"], c["Sk"]) for c in calls]
    want = {(False, F, F): L, (True, WHISPER_S, WHISPER_S): base.dec_layers,
            (False, WHISPER_S, F): base.dec_layers}
    if n_pre != 2 * base.dec_layers + L or \
            {k: kinds.count(k) for k in want} != want or \
            {(c["dtype"], c["Dh"], c["window"]) for c in calls} != \
            {(torch.bfloat16, base.head_dim, None)}:
        fail(f"whisper-medium prefill launched flash {n_pre} times as "
             f"{ {k: kinds.count(k) for k in set(kinds)} }, want {want}")
    logits = core.unembed_logits(params16["embed"]["table"], h)
    if h.shape != (B_PREFILL, base.d_model) or \
            tuple(cache["xk"].shape) != (base.dec_layers, B_PREFILL, F,
                                         base.n_kv_heads, base.head_dim) or \
            not bool(torch.isfinite(h).all()) or \
            not bool(torch.isfinite(logits).all()):
        fail("whisper-medium prefill: last hidden, cache or logits wrong")
    pf = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill16(params16, inputs)
        torch.cuda.synchronize()
        pf.append((time.perf_counter() - t0) * 1e3)
    pf_ms = float(np.mean(pf[1:]))
    print(f"main path: whisper-medium bf16 prefill ({L} + {base.dec_layers} "
          f"layers, {core.count_params(params16) / 1e9:.3f} B parameters) "
          f"B={B_PREFILL}, {WHISPER_S} decoder tokens against {F} frames: "
          f"flash launched {n_pre} times ({L} bidirectional {F} x {F}, "
          f"{base.dec_layers} causal, {base.dec_layers} cross {WHISPER_S} x "
          f"{F}); finite; {pf_ms:.2f} ms mean of 3 after a warm call ("
          + ", ".join(f"{t:.2f}" for t in pf) + f" ms), "
          f"{B_PREFILL * WHISPER_S / pf_ms * 1e3:.0f} decoder tokens/s "
          f"({B_PREFILL * (WHISPER_S + F) / pf_ms * 1e3:.0f} with the "
          f"frames)")
    del h, cache, logits, calls

    # b. golden
    check_golden_lm(dev, "golden_whisper.json", base, whisper)

    # c. decode on a prefilled cache vs the teacher-forced forward, f32
    cfg32 = dataclasses.replace(base, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = cast_params(params16, torch.float32)
    tok = inputs["tokens"][:1]
    fr = inputs["frames"][:1]
    n_dec = 3
    fa.LAUNCHES = 0
    h, cache = whisper.prefill(params32, cfg32, tok, fr,
                               max_len=WHISPER_S + n_dec)
    table = params32["embed"]["table"]
    seq = [tok]
    dec = steps.make_decode_step(cfg32, whisper)
    lg = core.unembed_logits(table, h)
    got = []
    for t in range(n_dec):
        nxt = lg.argmax(-1)
        seq.append(nxt[:, None])
        lg, cache = dec(params32, nxt, cache, WHISPER_S + t)
        got.append(lg)
    seq = torch.cat(seq, 1)
    ref = core.unembed_logits(table, whisper.forward(
        params32, cfg32, seq, frames=fr)[0])[:, WHISPER_S:]
    tol = DEC_ATOL_REL * spread(ref)
    err = max(float((g - ref[:, t]).abs().max()) for t, g in enumerate(got))
    h16, _ = whisper.forward(params16, cfg16, seq, frames=fr)
    err16 = float((core.unembed_logits(params16["embed"]["table"], h16)
                   [:, WHISPER_S:].float() - ref).abs().max())
    n_fwd_c = fa.LAUNCHES         # the prefill and the two forwards
    if not err <= tol < err16:
        miss(f"whisper-medium decode: {n_dec} steps off the float32 forward "
             f"by {err}, the bf16 forward by {err16}; tol {tol} must lie "
             f"between them")
    print(f"whisper-medium float32 ({L} + {base.dec_layers} layers): "
          f"{n_dec} decode steps on a {WHISPER_S}-token prefilled cache vs "
          f"the teacher-forced forward, max abs err {err:.4g}, tol "
          f"{tol:.4g} ({DEC_ATOL_REL:g} x spread); bf16 forward err "
          f"{err16:.4g}")
    del params32, params16, cache, h16, ref

    # d. one train step at 2 + 2 layers, kernels vs plain
    cfg = dataclasses.replace(base, n_layers=2, dec_layers=2)
    params = whisper.init(torch.Generator().manual_seed(TF_SEED + 6), cfg,
                          dev)
    batch = {**lm_batch(DataConfig(cfg.vocab, WHISPER_S, B_PREFILL), 0, dev),
             **train.side_inputs(cfg, B_PREFILL, 0, dev)}
    grads_vs_plain("whisper-medium train step (2 + 2 layers, bf16 "
                   "compute)", lambda p: whisper.loss_fn(p, cfg, batch,
                                                         remat=False),
                   params, 6, 6, (("enc_layers", "attn"),
                                  ("dec_layers", "attn"),
                                  ("dec_layers", "xattn")))
    return n_pre + n_fwd_c + 6, 6


def training_phases(dev) -> tuple:
    """Phases 18-22; returns (flash forward launches on their main paths,
    the largest flash backward error, the backward kernel's `kernels`
    row)."""
    import torch
    # 18. the backward kernel vs autograd of the plain version
    worst = check_flash_bwd(dev)
    torch.cuda.empty_cache()
    # 19. olmo-1b training at full width
    n_f19, n_b19, train_line, train_prof = train_olmo(dev)
    torch.cuda.empty_cache()
    # 20. card vs CPU
    n_f20, n_b20 = train_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    # 21. whisper-medium
    n_f21, n_b21 = whisper_phases(dev)
    torch.cuda.empty_cache()
    # 22. timing
    rows = time_flash_bwd(dev)
    print(train_line)
    print(train_prof)
    n_bwd = n_b19 + n_b20 + n_b21
    print(f"flash backward launches on the main paths: {n_bwd} ({n_b19} "
          f"olmo-1b training, {n_b20} card vs CPU, {n_b21} whisper train "
          f"step)")
    name, ms, plain_ms, bound, by, sdpa_ms = rows[0]
    return n_f19 + n_f20 + n_f21, worst, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "launches": n_bwd, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": sdpa_ms}


# ---------------------------------------------------------------------------
# phases 23-26: the SSD family's training path
# ---------------------------------------------------------------------------

# one smoke config of each family (transformer, MoE, VLM, hybrid, SSM,
# encdec) for the seed check
SEED_ARCHS = ("olmo-1b", "moonshot-v1-16b-a3b", "phi-3-vision-4.2b",
              "zamba2-1.2b", "mamba2-2.7b", "whisper-medium")
# SSD backward shapes (name, b, s, h, g, n, dt scale): zamba2's and
# mamba2-2.7b's layers at the prefill shape, a ragged s, an s inside one
# group (no split) and g > 1; dt x 0.05 makes the state gradient carried
# between the groups count
SSD_BWD_SHAPES = (("zamba2", 2, 4096, 64, 1, 64, 1.0),
                  ("mamba2-2.7b", 2, 4096, 80, 1, 128, 1.0),
                  ("ragged", 2, 1000, 64, 1, 64, 0.05),
                  ("one group", 2, 500, 64, 1, 64, 0.05),
                  ("g=2", 1, 1100, 8, 2, 128, 0.05))
# float32 gradients against `ssd_scan_bwd_plain`: max abs error over the
# gradient's largest magnitude (float32 sums in another order)
SSD_BWD_F32_REL = 1e-5
# bf16 against the plain version on the same bf16 inputs: the kernel keeps
# every product in float32 and rounds dx / dB / dC once, so only sum order
# and the rounding it flips separate them; relative RMS limit of each
# gradient, which the plain version with W and G o E rounded to bf16
# before their products (a tensor-core shortcut) must exceed on dx, dB, dC
SSD_BWD_BF16_RMS = 5e-4
# the SSD backward's bf16 launches by name in a profile (phase 26 reads
# each one's device time from the zamba2 step's profile)
SSD_BWD_LAUNCHES = ("ssd_bwd_walk", "ssd_bwd_pass", "ssd_bwd_chunk")
SSM_TRAIN_ARCH = "zamba2-1.2b"
SSM_TRAIN_B, SSM_TRAIN_S = 4, 2048
SSM_TRAIN_STEPS = 6
MAMBA2_LAYERS = 4               # mamba2-2.7b's depth cut (of 64)
MAMBA_KEYS = ("A_log", "dt_bias", "in_proj", "conv_w", "out_proj")
SSM_CKPT_DIR = ROOT / "build" / "chip_smoke_ssm_ckpt"


def check_seeds(dev) -> None:
    """Phase 23 a: one seed gives bit-equal weights on the CPU and the
    card for every family, and bit-equal side inputs."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import train
    from repro_torch.models import registry
    for arch in SEED_ARCHS:
        cfg, model = registry.get(arch, smoke=True)
        card = model.init(torch.Generator().manual_seed(0), cfg, dev)
        cpu = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
        leaves = list(zip(tree.leaves(card), tree.leaves(cpu)))
        bad = [i for i, (a, b) in enumerate(leaves)
               if a.device.type != "cuda" or not torch.equal(a.cpu(), b)]
        if bad:
            fail(f"seed: {arch} init from one seed differs between the card "
                 f"and the CPU on leaves {bad}")
        line = f"seed: {arch} init bit-equal on the card and the CPU " \
            f"({len(leaves)} leaves)"
        if cfg.family in ("encdec", "vlm"):
            for step in (0, 3):
                (k, a), = train.side_inputs(cfg, 2, step, dev).items()
                b = train.side_inputs(cfg, 2, step, "cpu")[k]
                if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                    fail(f"seed: {arch} side input {k} at step {step} "
                         f"differs between the card and the CPU")
            line += f"; side inputs ({k}) bit-equal at steps 0 and 3"
        print(line)


def ssd_bwd_inputs(gen, b, s, h, g, n, dtype, dt_scale):
    """x, dt, A, B, C and dy on the card, phase 6's draws."""
    import torch
    dev = gen.device

    def rn(shape, dt, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)

    x = rn((b, s, h, 64), dtype, 0.5)
    dt = dt_scale * torch.nn.functional.softplus(rn((b, s, h), torch.float32))
    A = -torch.exp(rn((h,), torch.float32, 0.3))
    return (x, dt, A, rn((b, s, g, n), dtype, 0.3), rn((b, s, g, n), dtype,
                                                      0.3),
            rn((b, s, h, 64), dtype))


def ssd_grads(ins, dy, chunk: int = 64):
    """The five gradients through `ssd_scan` (SSDScan on the card)."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    with torch.enable_grad():
        y = ss.ssd_scan(*leaves, chunk=chunk)
    return torch.autograd.grad(y, leaves, dy)


def check_ssd_forward_states(dev) -> None:
    """Phase 23 b: the forward's serving launch and the launch that keeps
    its group states (what `SSDScan` runs) give the same y bit for bit,
    and so does `ssd_scan` with inputs that need a gradient."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device=dev).manual_seed(10)
    for b, s, h, g, n in ((B_PREFILL, S_PREFILL, 64, 1, 64),
                          (B_PREFILL, S_PREFILL, 80, 1, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            ins = ssd_bwd_inputs(gen, b, s, h, g, n, dtype, 1.0)[:5]
            y = ss._ssd_cuda(*ins)
            y2, states = ss._ssd_cuda(*ins, states=True)
            leaves = [t.clone().requires_grad_() for t in ins]
            with torch.enable_grad():
                y3 = ss.ssd_scan(*leaves, chunk=64)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(y, y3.detach())) or \
                    tuple(states.shape) != (b, h, ss.n_groups(s), n, 64):
                fail(f"ssd forward b={b} s={s} h={h} n={n} {dtype}: y with "
                     f"the group states kept differs from the serving "
                     f"launch's")
            print(f"ssd forward b={b} s={s} h={h} n={n} {str(dtype)[6:]}: "
                  f"y bit-equal with and without the group states kept, "
                  f"and through SSDScan")


def check_ssd_bwd(dev, shapes=SSD_BWD_SHAPES, chunk: int = 64,
                  seed: int = 11) -> float:
    """Phase 23 c (and 28 a at chunk 128): the backward kernel (through
    `ssd_scan`'s autograd route) against `ssd_scan_bwd_plain` at `chunk`
    at `shapes`, float32 within SSD_BWD_F32_REL of each gradient's
    largest magnitude, bf16 within SSD_BWD_BF16_RMS relative RMS with the
    rounded control outside it; a second run bit-equal; returns the
    largest abs error."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device=dev).manual_seed(seed)
    names = ("dx", "ddt", "dA", "dB", "dC")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, s, h, g, n, dt_scale in shapes:
            *ins, dy = ssd_bwd_inputs(gen, b, s, h, g, n, dtype, dt_scale)
            b0 = ss.BWD_LAUNCHES
            got = ssd_grads(ins, dy, chunk)
            again = ssd_grads(ins, dy, chunk)
            calls = ss.BWD_LAUNCHES - b0
            want = ss.ssd_scan_bwd_plain(*ins, dy, chunk=chunk)
            torch.cuda.synchronize()
            label = (f"ssd bwd {name} b={b} s={s} h={h} g={g} n={n} dt "
                     f"x{dt_scale:g} {str(dtype)[6:]} chunk {chunk}")
            if calls != 2:
                fail(f"{label}: {calls} backward calls, want 2")
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                fail(f"{label}: two runs differ")
            rels, rms = [], []
            for k, a, w in zip(names, got, want):
                if a.dtype != w.dtype or not bool(torch.isfinite(a).all()):
                    fail(f"{label}: {k} not finite or not {w.dtype}")
                err = float((a.float() - w.float()).abs().max())
                top = float(w.float().abs().max())
                worst = max(worst, err)
                rels.append(err / top)
                rms.append(rel_rms(a.float(), w.float()))
                if dtype == torch.float32 and err > SSD_BWD_F32_REL * top:
                    miss(f"{label}: {k} off the plain version by "
                         f"{err / top:.3g} of its largest magnitude (tol "
                         f"{SSD_BWD_F32_REL:g})")
                if dtype == torch.bfloat16 and rms[-1] > SSD_BWD_BF16_RMS:
                    miss(f"{label}: {k} rel RMS {rms[-1]:.3g} off the plain "
                         f"version (tol {SSD_BWD_BF16_RMS:g})")
            line = (f"{label}: vs ssd_scan_bwd_plain, max err / max |.| "
                    + " ".join(f"{k} {r:.3g}" for k, r in zip(names, rels)))
            if dtype == torch.bfloat16:
                ctrl = ss.ssd_scan_bwd_plain(*ins, dy, chunk=chunk,
                                             rounded=True)
                c_rms = [rel_rms(c.float(), w.float())
                         for c, w in zip(ctrl, want)]
                low = min(c_rms[i] for i in (0, 3, 4))
                if low <= SSD_BWD_BF16_RMS:
                    miss(f"{label}: the rounded control is within the bf16 "
                         f"limit ({low:.3g}): the check tells nothing")
                line += ("; rel RMS " + " ".join(
                    f"{k} {r:.3g}" for k, r in zip(names, rms))
                    + f" (tol {SSD_BWD_BF16_RMS:g}); control (W, G o E "
                    f"rounded to bf16) " + " ".join(
                        f"{k} {r:.3g}" for k, r in zip(names, c_rms)))
            else:
                line += f" (tol {SSD_BWD_F32_REL:g})"
            print(line + "; a second run bit-equal")
            del ins, dy, got, again, want
    return worst


def mamba_grad_checks(label, grads, n_layers) -> None:
    """Every gradient finite, and MAMBA_KEYS nonzero in every mamba layer
    (the SSD kernel's output carries a gradient to each of them)."""
    import torch
    from repro_torch import tree
    bad = [i for i, g in enumerate(tree.leaves(grads))
           if not bool(torch.isfinite(g).all())]
    if bad:
        fail(f"{label}: gradient leaves {bad} not finite")
    mamba = grads["layers"]["mamba"]
    for key in MAMBA_KEYS:
        zero = [i for i in range(n_layers) if not bool((mamba[key][i] != 0)
                                                       .any())]
        if zero:
            fail(f"{label}: mamba.{key} has no gradient on layers {zero}")


def ssm_grads_vs_plain(label, model, params, cfg, batch, seq) -> tuple:
    """The loss and gradients of `model.loss_fn` through the SSD and
    flash kernels (SSD forward launches, backward calls and flash
    launches counted against one call a layer, without remat), every
    gradient checked (`mamba_grad_checks`), and again through the plain
    SSD and attention (with remat: autograd of the plain scan keeps
    every chunk's L x L products, ~0.6 GB a layer at B = 4 x S = 2048);
    returns (loss, grad norm, plain loss, plain grad norm)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss
    from repro_torch.launch import dryrun, steps
    from repro_torch.training import optimizer as opt
    L = cfg.n_layers
    n_attn = L // cfg.attn_every if cfg.attn_every else 0
    want = (L * ss.kernel_launches(seq), L, n_attn, n_attn)
    ss.LAUNCHES = ss.BWD_LAUNCHES = fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    loss, grads = steps.value_and_grad(
        lambda p: model.loss_fn(p, cfg, batch, remat=False), params)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = (ss.LAUNCHES, ss.BWD_LAUNCHES, fa.LAUNCHES, fa.BWD_LAUNCHES)
    if counts != want:
        fail(f"{label}: SSD {counts[0]} forward launches / {counts[1]} "
             f"backward calls, flash {counts[2]} / {counts[3]}; want {want}")
    mamba_grad_checks(label, grads, L)
    gnorm = float(opt.global_norm(grads))
    del grads
    torch.cuda.empty_cache()
    with dryrun.plain_kernels():
        loss_p, grads_p = steps.value_and_grad(
            lambda p: model.loss_fn(p, cfg, batch, remat=True), params)
    gnorm_p = float(opt.global_norm(grads_p))
    del grads_p
    loss, loss_p = float(loss), float(loss_p)
    if not (abs(loss - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p) and
            abs(gnorm - gnorm_p) <= TRAIN_GNORM_RTOL * gnorm_p):
        miss(f"{label}: through the kernels loss {loss} grad norm {gnorm}, "
             f"through the plain SSD and attention {loss_p} / {gnorm_p} "
             f"(rtol {TRAIN_LOSS_RTOL:g} / {TRAIN_GNORM_RTOL:g})")
    print(f"{label}: SSD {counts[0]} forward launches + {counts[1]} backward "
          f"calls, flash {counts[2]} + {counts[3]}; every gradient finite, "
          f"{' / '.join(MAMBA_KEYS)} nonzero on every layer; peak device "
          f"memory {peak_gb:.2f} GB; loss "
          f"{loss:.6f} vs {loss_p:.6f} through the plain SSD and attention "
          f"(rel {abs(loss - loss_p) / abs(loss_p):.3g}, tol "
          f"{TRAIN_LOSS_RTOL:g}), grad norm {gnorm:.6g} vs {gnorm_p:.6g} "
          f"(rel {abs(gnorm - gnorm_p) / gnorm_p:.3g}, tol "
          f"{TRAIN_GNORM_RTOL:g})")
    return loss, gnorm, loss_p, gnorm_p


def ssm_train_flops(cfg, B: int, S: int) -> float:
    """Products of one SSM / hybrid training step: 6 x parameters x
    tokens, the shared block's attention (3.5 x the forward's q.k and
    p.v) and every SSD scan's (3.5 x the forward's `ssd_ops`: forward
    and a backward of 2.5 x)."""
    import torch
    n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    s = cfg.ssm
    x = torch.empty((B, S, s.n_heads, s.head_dim), device="meta")
    Bm = torch.empty((B, S, s.n_groups, s.d_state), device="meta")
    return 6.0 * cfg.n_params * B * S + \
        3.5 * 4.0 * B * cfg.n_heads * cfg.head_dim \
        * attn_pairs(S, S, True, None) * n_attn + \
        3.5 * ssd_ops(x, Bm, s.chunk) * cfg.n_layers


def train_zamba2(dev) -> tuple:
    """Phase 24: zamba2-1.2b at full width and depth (38 mamba layers, 6
    shared-block calls; float32 parameters, bf16 compute), B =
    SSM_TRAIN_B x S = SSM_TRAIN_S: the first step through the kernels
    against the plain SSD and attention (`ssm_grads_vs_plain`);
    `launch.train.train` for SSM_TRAIN_STEPS AdamW steps with a
    checkpoint, restored bit for bit; every step's launches counted,
    losses finite and moving.  Returns (SSD forward launches, SSD
    backward calls, flash forward, flash backward on this path, the
    timing line, the initial weights and the batch)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss
    from repro_torch.launch import train
    from repro_torch.models import mamba_lm, registry
    from repro_torch.nn import core
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    cfg, _ = registry.get(SSM_TRAIN_ARCH)
    L = cfg.n_layers
    n_attn = L // cfg.attn_every
    t0 = time.perf_counter()
    params = mamba_lm.init(torch.Generator().manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    print(f"{SSM_TRAIN_ARCH} training: {L} mamba layers + {n_attn} shared "
          f"block calls, {core.count_params(params) / 1e9:.3f} B parameters "
          f"({cfg.param_dtype} parameters, {cfg.compute_dtype} compute), "
          f"B={SSM_TRAIN_B} S={SSM_TRAIN_S}; weights drawn on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = lm_batch(DataConfig(cfg.vocab, SSM_TRAIN_S, SSM_TRAIN_B), 0, dev)
    ssm_grads_vs_plain(f"{SSM_TRAIN_ARCH} first step", mamba_lm, params,
                       cfg, batch, SSM_TRAIN_S)
    torch.cuda.empty_cache()

    shutil.rmtree(SSM_CKPT_DIR, ignore_errors=True)
    rec = {"t": None, "rows": []}

    def on_step(s, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["rows"].append((s, float(m["loss"]), float(m["grad_norm"]),
                            (ss.LAUNCHES, ss.BWD_LAUNCHES, fa.LAUNCHES,
                             fa.BWD_LAUNCHES), (now - rec["t"]) * 1e3))
        ss.LAUNCHES = ss.BWD_LAUNCHES = fa.LAUNCHES = fa.BWD_LAUNCHES = 0
        rec["t"] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    ss.LAUNCHES = ss.BWD_LAUNCHES = fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    rec["t"] = time.perf_counter()
    p6, losses = train.train(SSM_TRAIN_ARCH, smoke=False, steps=SSM_TRAIN_STEPS,
                             batch=SSM_TRAIN_B, seq=SSM_TRAIN_S, device=dev,
                             ckpt_dir=str(SSM_CKPT_DIR),
                             ckpt_every=SSM_TRAIN_STEPS, log_every=1,
                             on_step=on_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if ckpt.latest_step(SSM_CKPT_DIR) != SSM_TRAIN_STEPS:
        fail(f"{SSM_TRAIN_ARCH} train: no checkpoint at step "
             f"{SSM_TRAIN_STEPS}")
    t1 = time.perf_counter()
    (restored, _), _ = ckpt.restore(SSM_CKPT_DIR, (params, opt.init(params)))
    restore_s = time.perf_counter() - t1
    if not all(torch.equal(a, b) for a, b in zip(tree.leaves(restored),
                                                 tree.leaves(p6))):
        fail(f"{SSM_TRAIN_ARCH} train: the restored checkpoint differs from "
             f"the trained parameters")
    del restored, p6
    shutil.rmtree(SSM_CKPT_DIR, ignore_errors=True)
    rows = rec["rows"]
    want = (L * ss.kernel_launches(SSM_TRAIN_S), L, n_attn,
            n_attn)
    for s, loss, gn, counts, _ in rows:
        if not (np.isfinite(loss) and np.isfinite(gn)) or counts != want:
            fail(f"{SSM_TRAIN_ARCH} train step {s}: loss {loss}, grad norm "
                 f"{gn}, launches (SSD forward, SSD backward, flash forward, "
                 f"flash backward) {counts}, want {want}")
    if len(rows) != SSM_TRAIN_STEPS or len(set(losses)) < 2:
        fail(f"{SSM_TRAIN_ARCH} train: losses {losses} do not move")
    step_ms = [r[4] for r in rows[1:]]
    ms = float(np.mean(step_ms))
    flops = ssm_train_flops(cfg, SSM_TRAIN_B, SSM_TRAIN_S)
    line = (f"{SSM_TRAIN_ARCH} train() (bf16 compute, B={SSM_TRAIN_B} "
            f"S={SSM_TRAIN_S}, {L} layers): losses "
            + ", ".join(f"{r[1]:.4f}" for r in rows) + "; grad norms "
            + ", ".join(f"{r[2]:.4g}" for r in rows)
            + f"; every step SSD {want[0]} forward launches + {L} backward "
            f"calls, flash {n_attn} + {n_attn}; ms per step {ms:.1f} (mean "
            f"of steps 1-{len(rows) - 1}: "
            + ", ".join(f"{t:.1f}" for t in step_ms) + f"; step 0 "
            f"{rows[0][4]:.1f}), {SSM_TRAIN_B * SSM_TRAIN_S / ms * 1e3:.0f} "
            f"tokens/s; {flops / 1e12:.1f} TFLOP of products a step, "
            f"{flops / (ms * 1e-3) / PEAK_BF16_OPS_S * 100:.1f} % of the bf16 "
            f"peak; peak device memory {peak_gb:.2f} GB; checkpoint restore "
            f"{restore_s:.1f} s")
    print(line)
    n = len(rows) + 1                # the trained steps and the first step
    return want[0] * n, L * n, n_attn * n, n_attn * n, line, params, batch


def ssm_card_vs_cpu(dev) -> tuple:
    """Phase 25 a: zamba2-1.2b at full width, 2 layers, float32, B = 1 x
    S = 512: one `make_train_step` (remat) on the card and on the CPU from
    the same numpy weights, held as phase 20 holds olmo-1b's; returns the
    card's (SSD forward launches, SSD backward calls)."""
    import dataclasses
    import torch
    from repro_torch import convert, tree
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import steps
    from repro_torch.models import mamba_lm, registry
    from repro_torch.training import optimizer as opt
    full, _ = registry.get(SSM_TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    seq = 512
    t0 = time.perf_counter()
    np_tree = convert.lm_params_numpy(cfg, LM_SEED)
    batch = lm_batch(DataConfig(cfg.vocab, seq, 1), 0, "cpu")
    step = steps.make_train_step(cfg, mamba_lm)
    out = []
    for d in (dev, torch.device("cpu")):
        params = convert.lm_params_from_numpy(np_tree, cfg, d)
        ss.LAUNCHES = ss.BWD_LAUNCHES = 0
        p, o, m = step(params, opt.init(params),
                       {k: v.to(d) for k, v in batch.items()})
        out.append((p, o, m, (ss.LAUNCHES, ss.BWD_LAUNCHES)))
    (pc, oc, mc, counts), (pp, op, mp, _) = out
    loss, loss_cpu = float(mc["loss"]), float(mp["loss"])
    rms = max(rel_rms(a.cpu(), b) for a, b in zip(tree.leaves(oc["m"]),
                                                  tree.leaves(op["m"])))
    lr = float(mp["lr"])
    dp = max(float((a.cpu() - b).abs().max()) for a, b in
             zip(tree.leaves(pc), tree.leaves(pp)))
    # remat: each layer's forward runs again in the backward
    want = (2 * cfg.n_layers * ss.kernel_launches(seq),
            cfg.n_layers)
    if counts != want or \
            abs(loss - loss_cpu) > XDEV_LOSS_RTOL * abs(loss_cpu) or \
            rms > XDEV_GRAD_RMS or dp > 2.1 * lr:
        miss(f"{SSM_TRAIN_ARCH} f32 train step, card vs CPU: SSD launches "
             f"{counts} (want {want}), loss {loss} vs {loss_cpu}, gradient "
             f"rel RMS {rms} (limit {XDEV_GRAD_RMS}), updated parameters "
             f"{dp} apart (limit 2.1 x lr {lr})")
    print(f"{SSM_TRAIN_ARCH} f32 make_train_step, 2 layers full width, B=1 "
          f"S={seq}, card vs CPU ({time.perf_counter() - t0:.1f} s): SSD "
          f"{counts[0]} forward launches ({cfg.n_layers} calls recomputed) + "
          f"{counts[1]} backward calls; loss {loss:.7f} vs {loss_cpu:.7f} "
          f"(rel {abs(loss - loss_cpu) / abs(loss_cpu):.3g}, tol "
          f"{XDEV_LOSS_RTOL:g}); worst per-leaf gradient rel RMS {rms:.3g} "
          f"(tol {XDEV_GRAD_RMS:g}); grad norm {float(mc['grad_norm']):.6g} "
          f"vs {float(mp['grad_norm']):.6g}; updated parameters max "
          f"{dp:.3g} apart (lr {lr:.3g}, tol 2.1 lr)")
    return counts


def mamba2_step(dev, tuned: bool = False) -> tuple:
    """Phase 25 b (and 28 e with `tuned`: SSD chunk 128): mamba2-2.7b at
    full width, depth cut to MAMBA2_LAYERS, one bf16-compute train step
    (B = SSM_TRAIN_B x S = SSM_TRAIN_S) through the kernels against the
    plain SSD at the config's chunk; returns (SSD forward launches,
    backward calls)."""
    import dataclasses
    import torch
    from repro_torch.configs import mamba2_2p7b
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import mamba_lm
    full = mamba2_2p7b.tuned() if tuned else mamba2_2p7b.config()
    cfg = dataclasses.replace(full, n_layers=MAMBA2_LAYERS)
    params = mamba_lm.init(torch.Generator().manual_seed(1), cfg, dev)
    batch = lm_batch(DataConfig(cfg.vocab, SSM_TRAIN_S, SSM_TRAIN_B), 0, dev)
    ssm_grads_vs_plain(f"mamba2-2.7b{' tuned' if tuned else ''} train step "
                       f"({MAMBA2_LAYERS} of {full.n_layers} layers, h "
                       f"{cfg.ssm.n_heads}, n {cfg.ssm.d_state}, chunk "
                       f"{cfg.ssm.chunk}, bf16 compute, B={SSM_TRAIN_B} "
                       f"S={SSM_TRAIN_S})", mamba_lm, params, cfg, batch,
                       SSM_TRAIN_S)
    return (MAMBA2_LAYERS * ss.kernel_launches(SSM_TRAIN_S),
            MAMBA2_LAYERS)


def time_ssd_bwd(dev) -> list:
    """Phase 26's kernel times: the backward kernel alone (CUDA events,
    10 calls, on the forward's own group states) at the bf16 shapes of
    zamba2's and mamba2-2.7b's prefill and of phase 24's step, beside
    `ssd_scan_bwd_plain` (1 call) and the bound; no library call
    computes the SSD gradient.  Returns the rows (name, ms, plain ms,
    bound, bound_by)."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for name, b, s, h, g, n in (
            ("zamba2", B_PREFILL, S_PREFILL, 64, 1, 64),
            ("mamba2-2.7b", B_PREFILL, S_PREFILL, 80, 1, 128),
            ("zamba2 train step", SSM_TRAIN_B, SSM_TRAIN_S, 64, 1, 64)):
        *ins, dy = ssd_bwd_inputs(gen, b, s, h, g, n, torch.bfloat16, 1.0)
        _, states = ss._ssd_cuda(*ins, states=True)
        bwd = lambda: ss._ssd_bwd_cuda(*ins, dy, states)  # noqa: E731
        bwd()
        ms = cuda_ms(bwd, 10)
        plain = lambda: ss.ssd_scan_bwd_plain(*ins, dy)  # noqa: E731
        plain()
        plain_ms = cuda_ms(plain, 1)
        bound, by = ssd_bwd_bound(ins[0], ins[3], 64)
        rows.append((name, ms, plain_ms, bound, by))
        print(f"ssd bwd kernel ({name}: b={b} s={s} h={h} p=64 g={g} n={n} "
              f"bf16): {ms:.4f} ms ({ss.bwd_kernel_launches(s)} launches); "
              f"plain {plain_ms:.2f} ms; bound {bound:.5f} ms by {by} "
              f"({bound / ms * 100:.1f} % of it reached); library call: "
              f"none")
        del ins, dy, states
    return rows


def check_ssd_bwd_ptxas() -> None:
    """Phase 26: the backward's ptxas lines (registers, spills) of every
    entry, and no spills in its bf16 launches."""
    from repro_torch.kernels import build
    lines = ptxas_kernels(build.BUILD_LOG.get("ssd_scan_bwd", ""))
    if not lines:
        print("ptxas ssd_scan_bwd: not measured (no build log in this "
              "process)")
        return
    for line in lines:
        print(f"ptxas ssd_scan_bwd {line}")
        if "bf16" in line.split()[0] and "spills 0 / 0 B" not in line:
            miss(f"ptxas ssd_scan_bwd: {line}: the bf16 backward spills")


def ssm_training_phases(dev) -> tuple:
    """Phases 23-26; returns (SSD forward launches on the main paths, the
    SSD backward's `kernels` row, flash forward and backward launches on
    the main paths)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import mamba_lm, registry
    from repro_torch.training import optimizer as opt
    # 23. the seed repair; the forward's states; the backward vs plain
    check_seeds(dev)
    check_ssd_forward_states(dev)
    worst = check_ssd_bwd(dev)
    torch.cuda.empty_cache()
    # 24. zamba2-1.2b training at full width and depth
    n_f24, n_b24, fa_f24, fa_b24, train_line, params, batch = \
        train_zamba2(dev)
    torch.cuda.empty_cache()
    # 26 (on these weights): a profile of one make_train_step
    cfg, _ = registry.get(SSM_TRAIN_ARCH)
    step = steps.make_train_step(cfg, mamba_lm)
    state = opt.init(params)
    prof = profile_device(lambda: step(params, state, batch),
                          f"{SSM_TRAIN_ARCH} make_train_step (remat), "
                          f"B={SSM_TRAIN_B} S={SSM_TRAIN_S}",
                          tags=("ssd_kernel", "ssd_bwd", *SSD_BWD_LAUNCHES,
                                "flash_kernel", "flash_bwd"))
    del params, state, batch
    torch.cuda.empty_cache()
    # 25. card vs CPU; mamba2-2.7b
    n_f25, n_b25 = ssm_card_vs_cpu(dev)
    n_f25b, n_b25b = mamba2_step(dev)
    torch.cuda.empty_cache()
    # 26. timing
    check_ssd_bwd_ptxas()
    rows = time_ssd_bwd(dev)
    print(train_line)
    print(prof)
    busy = {t: re.search(rf"{t} ([0-9.]+) ms", prof)
            for t in ("ssd_bwd", *SSD_BWD_LAUNCHES)}
    print(f"{SSM_TRAIN_ARCH} make_train_step: SSD backward busy "
          + (f"{busy['ssd_bwd'].group(1)} ms ({cfg.n_layers} calls); a "
             "launch: " + ", ".join(
                 f"{t} {float(busy[t].group(1)) / cfg.n_layers:.4f} ms"
                 for t in SSD_BWD_LAUNCHES)
             if all(busy.values()) else "not measured"))
    n_bwd = n_b24 + n_b25 + n_b25b
    print(f"ssd backward calls on the main paths: {n_bwd} ({n_b24} "
          f"zamba2-1.2b training, {n_b25} card vs CPU, {n_b25b} mamba2-2.7b)")
    _, ms, plain_ms, bound, by = rows[0]
    return n_f24 + n_f25 + n_f25b, {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:28",
        "launches": n_bwd, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}, fa_f24, fa_b24


# ---------------------------------------------------------------------------
# phase 27: gemma3-4b training (the Dh 256 backward on a main path)
# ---------------------------------------------------------------------------

GEMMA_TRAIN_ARCH = "gemma3-4b"
GEMMA_TRAIN_LAYERS = 12         # of 34: 10 local and 2 global (5:1)
GEMMA_TRAIN_STEPS = 3


def train_gemma3(dev) -> tuple:
    """Phase 27: gemma3-4b at full width, depth cut to GEMMA_TRAIN_LAYERS
    (10 local, 2 global: `transformer.layer_flags`), float32 parameters,
    bf16 compute, B = TRAIN_B x S = TRAIN_S: the first step through the
    kernels (12 + 12 launches, every gradient finite, wq / wk / wv nonzero
    on every layer) against the same step through the plain attention
    (under remat: the plain scores of 12 layers would not fit beside the
    rest), held as phase 19 holds olmo-1b's; GEMMA_TRAIN_STEPS steps of
    `launch.train.train` (12 + 12 launches each, losses and grad norms
    finite): ms a step, tokens/s, share of the bf16 peak (`train_flops`,
    each layer's window counted), peak device memory; a profile of one
    `make_train_step`.  Returns (forward launches, backward launches, the
    timing line, the profile)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train
    from repro_torch.models import registry, transformer
    from repro_torch.nn import core
    from repro_torch.training import optimizer as opt
    full, _ = registry.get(GEMMA_TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=GEMMA_TRAIN_LAYERS)
    L = cfg.n_layers
    n_local = sum(w < transformer.BIG_WINDOW
                  for w in transformer.layer_flags(cfg)["window"])
    t0 = time.perf_counter()
    params = transformer.init(torch.Generator().manual_seed(0), cfg, dev)
    print(f"{GEMMA_TRAIN_ARCH} training: {L} of {full.n_layers} layers "
          f"({n_local} local, window {cfg.window}; {L - n_local} global), "
          f"{core.count_params(params) / 1e9:.3f} B parameters "
          f"({cfg.param_dtype} parameters, {cfg.compute_dtype} compute), "
          f"B={TRAIN_B} S={TRAIN_S}; weights drawn on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = lm_batch(DataConfig(cfg.vocab, TRAIN_S, TRAIN_B), 0, dev)
    grads_vs_plain(f"{GEMMA_TRAIN_ARCH} first step ({L} layers)",
                   lambda p: transformer.loss_fn(p, cfg, batch, remat=False),
                   params, L, L, (("layers", "attn"),),
                   plain_loss_of=lambda p: transformer.loss_fn(
                       p, cfg, batch, remat=True))
    torch.cuda.empty_cache()
    rec = {"t": None, "rows": []}

    def on_step(s, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["rows"].append((s, float(m["loss"]), float(m["grad_norm"]),
                            fa.LAUNCHES, fa.BWD_LAUNCHES,
                            (now - rec["t"]) * 1e3))
        fa.LAUNCHES = fa.BWD_LAUNCHES = 0
        rec["t"] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    rec["t"] = time.perf_counter()
    _, losses = train.train(GEMMA_TRAIN_ARCH, smoke=False,
                            steps=GEMMA_TRAIN_STEPS, batch=TRAIN_B,
                            seq=TRAIN_S, device=dev, log_every=1,
                            on_step=on_step, layers=L)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = rec["rows"]
    if len(rows) != GEMMA_TRAIN_STEPS:
        fail(f"{GEMMA_TRAIN_ARCH} train: {len(rows)} steps, want "
             f"{GEMMA_TRAIN_STEPS}")
    for s, loss, gn, nf, nb, _ in rows:
        if not (np.isfinite(loss) and np.isfinite(gn)) or (nf, nb) != (L, L):
            fail(f"{GEMMA_TRAIN_ARCH} train step {s}: loss {loss}, grad norm "
                 f"{gn}, flash {nf} forward / {nb} backward launches (want "
                 f"{L} / {L})")
    step_ms = [r[5] for r in rows[1:]]
    ms = float(np.mean(step_ms))
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    line = (f"{GEMMA_TRAIN_ARCH} train() (bf16 compute, B={TRAIN_B} "
            f"S={TRAIN_S}, {L} of {full.n_layers} layers): losses "
            + ", ".join(f"{r[1]:.4f}" for r in rows) + "; grad norms "
            + ", ".join(f"{r[2]:.4g}" for r in rows)
            + f"; {L} + {L} flash launches every step; ms per step {ms:.1f} "
            f"(mean of steps 1-{len(rows) - 1}: "
            + ", ".join(f"{t:.1f}" for t in step_ms) + f"; step 0 "
            f"{rows[0][5]:.1f}), {TRAIN_B * TRAIN_S / ms * 1e3:.0f} "
            f"tokens/s; {flops / 1e12:.1f} TFLOP of products a step (each "
            f"layer's window counted), "
            f"{flops / (ms * 1e-3) / PEAK_BF16_OPS_S * 100:.1f} % of the bf16 "
            f"peak; peak device memory {peak_gb:.2f} GB")
    step = steps.make_train_step(cfg, transformer)
    state = opt.init(params)
    prof = profile_device(lambda: step(params, state, batch),
                          f"{GEMMA_TRAIN_ARCH} make_train_step (remat), {L} "
                          f"layers, B={TRAIN_B} S={TRAIN_S}",
                          tags=("flash_kernel", "flash_bwd"))
    n = L * (1 + GEMMA_TRAIN_STEPS)  # the first step and the trained steps
    return n, n, line, prof



# ---------------------------------------------------------------------------
# phase 28: mamba2-2.7b's tuned config (SSD chunk 128)
# ---------------------------------------------------------------------------

TUNED_CHUNK = 128               # mamba2_2p7b.tuned()'s ssm.chunk
# the SSD at mamba2-2.7b's prefill shape (name, b, s, h, g, n, dt scale)
MAMBA2_SSD_SHAPE = ("mamba2-2.7b", B_PREFILL, S_PREFILL, 80, 1, 128, 1.0)


def ssm_prefill_flops(cfg, B: int, S: int) -> float:
    """Products of one SSM prefill (2 flops a multiply-add): every token
    through each layer's projections (2 x parameters, less the
    embedding, which is a lookup), each layer's SSD scan at the kernels'
    tile (`ssd_ops`), and the last position's unembedding."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    s = cfg.ssm
    x = torch.empty((B, S, s.n_heads, s.head_dim), device="meta")
    Bm = torch.empty((B, S, s.n_groups, s.d_state), device="meta")
    emb = cfg.vocab * cfg.d_model
    return 2.0 * B * S * (cfg.n_params - emb) + \
        cfg.n_layers * ssd_ops(x, Bm, ss.TILE) + 2.0 * B * emb


def check_ssd_tuned_chunk(dev) -> tuple:
    """Phase 28 a: the SSD forward at mamba2-2.7b's prefill shape asked
    for at chunk 128 against `ssd_scan_plain(chunk=128)`, with phase 11's
    tolerances and bf16 control (at chunk 128), its launches equal to a
    chunk-64 call's and its output bit-equal to it (one kernel, one tile);
    the backward at the same shape against `ssd_scan_bwd_plain(chunk=128)`
    with phase 23 c's; the forward's ms at chunk 64 and 128 (CUDA events,
    20 calls each, in turns), the plain version's at 128 and the bound.
    Returns (forward max abs err, backward max abs err, timing line,
    (ms, plain ms, bound, bound by))."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    name, b, s, h, g, n, _ = MAMBA2_SSD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(13)
    worst = 0.0
    timing = None
    for dtype in (torch.bfloat16, torch.float32):
        tol = LM_TOL[str(dtype)[6:]]
        x, dt, A, Bm, Cm, _ = ssd_bwd_inputs(gen, b, s, h, g, n, dtype, 1.0)
        ins = (x, dt, A, Bm, Cm)
        n0 = ss.LAUNCHES
        got = ss.ssd_scan(*ins, chunk=TUNED_CHUNK)
        n128 = ss.LAUNCHES - n0
        at64 = ss.ssd_scan(*ins, chunk=64)
        n64 = ss.LAUNCHES - n0 - n128
        want = ss.ssd_scan_plain(*ins, chunk=TUNED_CHUNK)
        label = (f"ssd {name} b={b} s={s} h={h} g={g} n={n} "
                 f"{str(dtype)[6:]} chunk {TUNED_CHUNK}")
        worst = max(worst, hold(label, got, want, max(tol, 1e-4), 5 * tol))
        torch.cuda.synchronize()
        if n128 != n64 or n128 != ss.kernel_launches(s) or \
                not torch.equal(got, at64):
            fail(f"{label}: {n128} launches (chunk 64: {n64}), or y differs "
                 f"from the chunk-64 call's")
        if dtype == torch.bfloat16:
            check_ssd_bf16(got, want, *ins, label, chunk=TUNED_CHUNK)
            runs = {64: [], TUNED_CHUNK: []}
            for c in (64, TUNED_CHUNK, TUNED_CHUNK, 64):
                fn = lambda c=c: ss.ssd_scan(*ins, chunk=c)  # noqa: E731
                fn()
                runs[c].append(cuda_ms(fn, 20))
            plain = lambda: ss.ssd_scan_plain(  # noqa: E731
                *ins, chunk=TUNED_CHUNK)
            plain()
            plain_ms = cuda_ms(plain, 3)
            bound, by = ssd_bound(x, Bm, ss.TILE)
            ms = float(sum(runs[TUNED_CHUNK]) / 2)
            timing = (f"ssd kernel ({name} prefill shape b={b} s={s} h={h} "
                      f"p=64 g={g} n={n} bf16), in turns: chunk 64 "
                      + " / ".join(f"{t:.4f}" for t in runs[64])
                      + f" ms, chunk {TUNED_CHUNK} "
                      + " / ".join(f"{t:.4f}" for t in runs[TUNED_CHUNK])
                      + f" ms ({n128} launches a call either way); plain at "
                      f"chunk {TUNED_CHUNK} {plain_ms:.3f} ms; bound "
                      f"{bound:.5f} ms by {by}")
            row = (ms, plain_ms, bound, by)
        print(f"{label}: {n128} launches, as at chunk 64, y bit-equal to "
              f"the chunk-64 call's")
        del x, dt, A, Bm, Cm, ins, got, at64, want
    bwd = check_ssd_bwd(dev, (MAMBA2_SSD_SHAPE,), TUNED_CHUNK, seed=14)
    return worst, bwd, timing, row


def mamba2_tuned_phases(dev) -> tuple:
    """Phase 28: mamba2-2.7b's tuned config (SSD chunk 128) on the card
    through the user's entry points; returns (SSD forward launches and
    backward calls on the main paths, the forward's and backward's
    largest errors, the forward's timing row at mamba2's shape)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import mamba2_2p7b
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import steps
    from repro_torch.models import mamba_lm
    from repro_torch.nn import core
    # 28 a. the SSD kernels at chunk 128
    err_f, err_b, timing, row = check_ssd_tuned_chunk(dev)
    torch.cuda.empty_cache()
    # 28 b. the full-depth bf16 prefill
    base = mamba2_2p7b.tuned()
    cfg16 = dataclasses.replace(base, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
    cfg32 = dataclasses.replace(base, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    t0 = time.perf_counter()
    params32 = mamba_lm.init(torch.Generator().manual_seed(LM_SEED), cfg32,
                             dev)
    gen_s = time.perf_counter() - t0
    params16 = cast_params(params32, torch.bfloat16)
    print(f"mamba2-2.7b tuned: {base.n_layers} layers, SSD chunk "
          f"{base.ssm.chunk}, pure_dp {base.pure_dp} (a mesh knob, inert on "
          f"one card); {cfg16.n_params / 1e9:.3f} B parameters; seeded "
          f"weights (`mamba_lm.init`, a CPU generator) in {gen_s:.1f} s")
    tokens = torch.as_tensor(np.random.default_rng(LM_SEED + 1).integers(
        0, base.vocab, (B_PREFILL, S_PREFILL)), device=dev)
    prefill16 = steps.make_prefill_step(cfg16, mamba_lm)
    want = base.n_layers * ss.kernel_launches(S_PREFILL)
    ss.LAUNCHES = 0
    h = prefill16(params16, {"tokens": tokens})
    torch.cuda.synchronize()
    n_prefill = ss.LAUNCHES
    if n_prefill != want:
        fail(f"mamba2-2.7b tuned prefill launched the SSD kernels "
             f"{n_prefill} times, want {want}")
    logits = core.unembed_logits(params16["embed"]["table"], h)
    if h.shape != (B_PREFILL, base.d_model) or not bool(
            torch.isfinite(logits).all()):
        fail("mamba2-2.7b tuned prefill: last hidden or logits not finite")
    print(f"main path: mamba2-2.7b tuned bf16 prefill B={B_PREFILL} "
          f"S={S_PREFILL}: SSD launched {n_prefill} times ({base.n_layers} "
          f"x {ss.kernel_launches(S_PREFILL)}, as at chunk 64); last hidden "
          f"and logits {tuple(logits.shape)} finite")
    torch.cuda.reset_peak_memory_stats()
    pf = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill16(params16, {"tokens": tokens})
        torch.cuda.synchronize()
        pf.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pf_ms = float(np.mean(pf[1:]))
    share = ssm_prefill_flops(base, B_PREFILL, S_PREFILL) / (
        pf_ms / 1e3) / PEAK_BF16_OPS_S
    print(f"mamba2-2.7b tuned prefill (bf16, B={B_PREFILL} S={S_PREFILL}, "
          f"{base.n_layers} layers): {pf_ms:.2f} ms mean of 3 after a warm "
          f"call (" + ", ".join(f"{t:.2f}" for t in pf) + " ms), "
          f"{B_PREFILL * S_PREFILL / pf_ms * 1e3:.0f} tokens/s, "
          f"{100 * share:.1f} % of the bf16 peak (ssm_prefill_flops); peak "
          f"device memory {peak_gb:.2f} GB")
    print(profile_device(lambda: prefill16(params16, {"tokens": tokens}),
                         f"mamba2-2.7b tuned bf16 prefill, B={B_PREFILL} "
                         f"S={S_PREFILL}"))
    print(timing)
    del h, logits
    # 28 c. the golden (4 layers, float32 vs the JAX reference, chunk 128)
    check_golden_lm(dev, "golden_mamba2.json", base, mamba_lm)
    # 28 d. the Server, float32, full width and depth
    serve_and_check(cfg32, cfg16, params32, params16, mamba_lm, dev)
    del params16, params32
    torch.cuda.empty_cache()
    # 28 e. a train step at 4 layers through SSDScan at chunk 128
    n_f, n_b = mamba2_step(dev, tuned=True)
    torch.cuda.empty_cache()
    return n_prefill + n_f, n_b, err_f, err_b, row


# ---------------------------------------------------------------------------
# phase 29: the perception nets
# ---------------------------------------------------------------------------

NET_SEED = 5
NET_TOL = 1e-5                  # float32, of the output's largest entry
NET_F64_TOL = 1e-9              # float64, of the output's largest entry
# the Conformer's attention saturates as its activations grow (logits
# ~450), so float32 sum order moves its output by up to ~6e-3 of the
# largest logit on either device (against float64: the card 3.9e-3, the
# CPU 6.1e-3, my chip run 3, PR 24): its card float32 run is held to the
# CPU's float64 run within NET_F32_VS_F64, under what TF32 moves (17-54
# of ~450, 4-12 %, emulated on the CPU), and a TF32 run must miss it
NET_F32_VS_F64 = {"asr_conformer": 1.5e-2}


def _double(tree):
    from repro_torch import tree as _tree
    return _tree.map(lambda t: t.double(), tree)


def _net_err(got, want) -> float:
    """Max abs error over a net's outputs, over the largest |want| (at
    least 1)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"net output not finite or of shape {tuple(g.shape)}")
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return max(float((g.cpu().double() - w.double()).abs().max())
               for g, w in zip(got, want)) / scale


def perception_phase(dev) -> None:
    """Phase 29: each of the six nets at its `measured_flops` shape on the
    card against its CPU run on the same seeded weights and input, TF32
    off (cuDNN's float32 convolutions default to it): in float64 within
    NET_F64_TOL of the largest output (the function), in float32 within
    NET_TOL, but for NET_F32_VS_F64 (the Conformer) whose card float32
    run is held to the CPU's float64 run instead, with a TF32 run as the
    control that must miss; ms per call in float32 (CUDA events, 20 calls
    after a warm one) and `torch_flops()` beside XLA's count."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.perception import nets
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ours, xla = nets.torch_flops(), nets.measured_flops()
    for i, (key, (name, shape)) in enumerate(nets.FLOPS_INPUTS.items()):
        params = nets.init(name, torch.Generator().manual_seed(NET_SEED + i),
                           "cpu")
        x = torch.from_numpy(np.random.default_rng(NET_SEED + i)
                             .standard_normal(shape).astype(np.float32))
        fn = nets.NET_FNS[name]
        card = tree.map(lambda t: t.to(dev), params)
        xd = x.to(dev)
        want, exact = fn(params, x), fn(_double(params), x.double())
        got, got64 = fn(card, xd), fn(_double(card), xd.double())
        torch.cuda.synchronize()
        err, err64 = _net_err(got, want), _net_err(got64, exact)
        if err64 > NET_F64_TOL:
            miss(f"{name}: card off the CPU in float64 by {err64:.3g} of "
                 f"the largest output (tol {NET_F64_TOL:g})")
        if name in NET_F32_VS_F64:
            tol = NET_F32_VS_F64[name]
            vs64 = _net_err(got, exact)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = _net_err(fn(card, xd), exact)
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            if vs64 > tol:
                miss(f"{name}: card float32 off the CPU's float64 by "
                     f"{vs64:.3g} of the largest output (tol {tol:g})")
            if tf32 <= tol:
                miss(f"{name}: the TF32 control is within the float32 "
                     f"limit ({tf32:.3g} <= {tol:g}), so the check would "
                     f"not see TF32")
            f32 = (f"float32 vs the CPU's float64 {vs64:.3g} (tol {tol:g}; "
                   f"the CPU's own float32 {_net_err(want, exact):.3g}, "
                   f"card vs CPU float32 {err:.3g}), TF32 control "
                   f"{tf32:.3g} (must exceed the tol)")
        else:
            if err > NET_TOL:
                miss(f"{name}: card off the CPU in float32 by {err:.3g} of "
                     f"the largest output (tol {NET_TOL:g})")
            f32 = f"float32 {err:.3g} (tol {NET_TOL:g})"
        call = lambda: fn(card, xd)  # noqa: E731
        call()
        ms = cuda_ms(call, 20)
        print(f"perception {name} {tuple(shape)}: card vs CPU, of the "
              f"largest output: float64 {err64:.3g} (tol {NET_F64_TOL:g}), "
              f"{f32}; {ms:.4f} ms a call (float32); products "
              f"{ours[key] / 1e6:.3f} MFLOP (FlopCounterMode) beside XLA's "
              f"{xla[key] / 1e6:.3f} MFLOP (frozen; it counts the "
              f"reference's in-call weight draws and elementwise work); "
              f"{ours[key] / ms / 1e9:.3f} TFLOP/s")


# ---------------------------------------------------------------------------
# phase 30: the measured-cell harness
# ---------------------------------------------------------------------------

HARNESS_CELLS = (("mamba2-2.7b", "prefill_32k", True),
                 ("olmo-1b", "train_4k", False))


def harness_phase(dev) -> tuple:
    """Phase 30: `launch.dryrun.run_cell` on HARNESS_CELLS (mamba2-2.7b
    tuned x prefill_32k, olmo-1b x train_4k) into a temporary directory,
    each at its batch cut; each artifact's step ms, peak memory, counted
    FLOPs against the analytical compute term, `roofline_fraction` and
    the share of the roofline reached; then `roofline_grid` over the
    directory.  Returns (SSD forward launches, flash forward launches,
    flash backward calls) of the two cells."""
    import tempfile
    from repro_torch.configs import mamba2_2p7b
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss
    from repro_torch.launch import dryrun, sweep
    counts = [0, 0, 0]
    with tempfile.TemporaryDirectory() as d:
        for arch, shape, tuned in HARNESS_CELLS:
            ss.LAUNCHES = fa.LAUNCHES = fa.BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, d, device=dev,
                                  cfg=mamba2_2p7b.tuned() if tuned else None)
            wall = time.perf_counter() - t0
            counts = [counts[0] + ss.LAUNCHES, counts[1] + fa.LAUNCHES,
                      counts[2] + fa.BWD_LAUNCHES]
            label = f"harness {arch}{' tuned' if tuned else ''} x {shape}"
            if rec.get("skipped"):
                print(f"{label}: skipped ({rec['reason']})")
                continue
            if not rec.get("ok"):
                fail(f"{label}: {rec.get('error')}\n{rec.get('traceback')}")
            t = rec["terms"]
            print(f"{label}: batch {rec['batch']} (reduced: "
                  f"{'; '.join(rec['reduced']) or 'none'}); steps "
                  + ", ".join(f"{x:.1f}" for x in rec["step_ms"])
                  + f" ms after a {rec['warmup_s']:.2f} s warm-up, "
                  f"{rec['tokens_per_s']:.0f} tokens/s; peak memory "
                  f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB (analytical "
                  f"{rec['memory']['analytical_bytes'] / 1e9:.2f}); counted "
                  f"{rec['flops_per_dev'] / 1e12:.2f} TFLOP (on "
                  f"{rec['flops_counted_on']}) -> compute term "
                  f"{t['compute_s']:.4f} s vs the analytical "
                  f"{rec['analytical_compute_s']:.4f} s; memory term "
                  f"{t['memory_s']:.4f} s; dominant {rec['dominant']}, "
                  f"roofline_fraction {rec['roofline_fraction']:.3f}, "
                  f"useful_flops_ratio {rec['useful_flops_ratio']:.3f}; the "
                  f"step reached {100 * rec['achieved_fraction']:.1f} % of "
                  f"its bound; SSD launches {ss.LAUNCHES}, flash "
                  f"{fa.LAUNCHES} + {fa.BWD_LAUNCHES} backward; {wall:.1f} s")
        rows = sweep.roofline_grid(d)
        by = {}
        for r in rows:
            by[r["source"]] = by.get(r["source"], 0) + 1
        print(f"roofline_grid over the harness directory: {len(rows)} cells, "
              + ", ".join(f"{v} {k}" for k, v in sorted(by.items())) + "; "
              + "; ".join(
                  f"{r['arch']} x {r['shape']}: at its global batch "
                  f"{r['batch']} bound {r['bound_s']:.4f} s by "
                  f"{r['dominant']} (analytical); measured at batch "
                  f"{m['batch']}: bound {m['bound_s']:.4f} s by "
                  f"{m['dominant']}, step {m['step_s']:.4f} s, "
                  f"{100 * m['achieved_fraction']:.1f} % of the bound"
                  for r in rows if r["source"] == "dryrun"
                  for m in (r["measured"],)))
        if by.get("dryrun", 0) != sum(
                sweep.cell_status(d, a, s) == "ok"
                for a, s, _ in HARNESS_CELLS):
            fail("roofline_grid did not read every ok harness artifact")
    return tuple(counts)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no card")
    from repro_torch.core import daysim
    from repro_torch.kernels import build, day_scan as ds
    from repro_torch.serving.twin import DesignTwin

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"device: {kind} x{torch.cuda.device_count()} ({smi}); torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    build.build_all(("day_scan", "flash_attention", "flash_attention_bwd",
                     "ssd_scan", "ssd_scan_bwd",
                     ("day_scan", ("DAY_SCAN_PROBE",))))
    build.load("day_scan")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall; nvcc "
          + ", ".join(f"{k} {v:.2f} s"
                      for k, v in sorted(build.BUILD_SECONDS.items())))
    for line in build.BUILD_LOG.get("day_scan", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas day_scan: {line.strip()}")
    print("ptxas flash_attention: " + "; ".join(ptxas_kernels(
        build.BUILD_LOG.get("flash_attention", ""))))
    print("ptxas flash_attention_bwd: " + "; ".join(ptxas_kernels(
        build.BUILD_LOG.get("flash_attention_bwd", ""))))
    print("ptxas ssd_scan_bwd: " + "; ".join(ptxas_kernels(
        build.BUILD_LOG.get("ssd_scan_bwd", ""))))

    # 3. kernel vs plain on the serving grid's tables
    golden = json.loads((ROOT / "src" / "repro_torch" / "data"
                         / "golden_day_pareto.json").read_text())
    dt_s = golden["dt_s"]
    pipe = daysim._fused_pipeline(dev, dt_s=dt_s)     # the default grid
    full, _ = daysim.day_tables(pipe)
    n, t, n_lvl = ds._shape(full)
    print(f"serving grid: N={n} combos ({pipe.asm.n_real} real), "
          f"T={t} steps, L={n_lvl} levels")
    worst = 0.0
    for size in (n, 63, 200):
        tb = full if size == n else resize(full, size)
        got = ds.day_scan(tb)
        torch.cuda.synchronize()
        worst = max(worst, compare(got, ds.day_scan_plain(tb)))
        print(f"day_scan kernel == plain at N={size}: all nine outputs "
              f"bit for bit, max abs err {worst:.3g}")
    for size in (n, 63, 1):
        tb = full if size == n else resize(full, size)
        got = ds.day_scan(tb, full=True)
        short = ds.day_scan(tb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ds.day_scan_plain(tb, full=True)
        torch.cuda.synchronize()
        plain_full_s = time.perf_counter() - t0
        worst = max(worst, compare(got, want))
        for k in ds.OUTS:
            if not torch.equal(got[k], short[k]):
                fail(f"full-trace mode {k} differs from the default mode's "
                     f"at N={size}")
        print(f"day_scan full-trace mode == plain at N={size}: all "
              f"{len(got)} outputs bit for bit (plain {plain_full_s:.1f} s); "
              f"its nine equal to the default mode's; thermal latch steps "
              f"{int(want['th_state'].sum())}, SoC latch steps "
              f"{int(want['soc_state'].sum())}")

    # 4. the main path through the user's entry point
    ds.LAUNCHES = 0
    twin = DesignTwin(dt_s=dt_s)                  # warm query
    if ds.LAUNCHES != 1:
        fail(f"warm query launched the kernel {ds.LAUNCHES} times")
    base = twin.query()
    check_golden("base", base, golden["queries"]["base"])
    warm_first_ms = twin.stats.last_ms
    serial = {"base": base}
    what_if_ms = {}
    for name, q in golden["queries"].items():
        if name == "base":
            continue
        before = ds.LAUNCHES
        rep = twin.what_if(**golden_overrides(q["overrides"], daysim))
        what_if_ms[name] = twin.stats.last_ms
        if ds.LAUNCHES != before + 1:
            fail(f"what-if {name} launched the kernel "
                 f"{ds.LAUNCHES - before} times")
        check_golden(name, rep, q)
        serial[name] = rep
        print(f"what-if {name}: {len(rep)} combos, front "
              f"{int(rep.front_mask.sum())}, survive "
              f"{int(rep.survives().sum())}: matches the golden")
    launches = ds.LAUNCHES
    print(f"main path: {launches} day_scan launches for "
          f"{twin.stats.queries} queries; base front "
          f"{int(base.front_mask.sum())} matches the golden")
    n_twin, err_twin = twin_paths(twin, golden, serial, dt_s)
    launches += n_twin
    worst = max(worst, err_twin)
    n_sim, n_full, err_sim = simulate_days(dt_s)
    worst = max(worst, err_sim)
    print(f"day_scan launches on the main path: {launches} default-mode, "
          f"{n_full} full-trace ({launches + n_sim} in all)")
    launches += n_sim
    steady_state_paths()
    sensitivity_check()
    n_day, err_day = relaxed_day_check(ds)
    n_opt, err_opt, _, opt = optimize_policy_check(ds)
    calibration_check()
    worst = max(worst, err_day, err_opt)
    print(f"day_scan launches on the gradient path: {n_day + n_opt} "
          f"full-trace ({launches + n_day + n_opt} on the main path in all)")
    launches += n_day + n_opt
    n_fleet, err_fleet = fleet_paths()
    worst = max(worst, err_fleet)
    print(f"day_scan launches on the fleet layer: {n_fleet} full-trace "
          f"({launches + n_fleet} on the main path in all)")
    launches += n_fleet

    # 5. timing (launches from here on are not the main path's)
    lib_fn = ds._day_scan_cuda
    for _ in range(3):
        lib_fn(full)
    kernel_ms = cuda_ms(lambda: lib_fn(full), 50)
    one = resize(full, 1)
    lib_fn(one)
    one_ms = cuda_ms(lambda: lib_fn(one), 20)
    wide = resize(full, 1024)
    lib_fn(wide)
    wide_ms = cuda_ms(lambda: lib_fn(wide), 20)
    lib_fn(full, True)
    full_ms = cuda_ms(lambda: lib_fn(full, True), 50)
    lib_fn(one, True)
    full_one_ms = cuda_ms(lambda: lib_fn(one, True), 20)
    fb_ms, fb_by = bound_ms(n, t, n_lvl, len(ds.TRACE_OUTS))
    fb1_ms, fb1_by = bound_ms(1, t, n_lvl, len(ds.TRACE_OUTS))
    floor = lambda: ds.probe_launch(full, "no loads or stores")  # noqa: E731
    floor()
    floor_ms = cuda_ms(floor, 50)
    mhz, max_mhz = sm_clocks(lambda: lib_fn(full), 1.0)
    ds.day_scan_plain(full)
    plain_ms = cuda_ms(lambda: ds.day_scan_plain(full), 2)
    b_ms, b_by = bound_ms(n, t, n_lvl)
    for _ in range(2):
        twin.query()
    q_ms = []
    for _ in range(10):
        twin.query()
        q_ms.append(twin.stats.last_ms)
    print(f"day_scan kernel: {kernel_ms:.4f} ms at N={n} T={t} L={n_lvl}; "
          f"one combo (N=1): {one_ms:.4f} ms; N=1024 (16 grids): "
          f"{wide_ms:.4f} ms")
    print(f"day_scan chain floor (probe mode no loads or stores, N={n}): "
          f"{floor_ms:.4f} ms = {floor_ms * 1e6 / t:.1f} ns, "
          f"{floor_ms * 1e3 * float(mhz) / t:.0f} SM cycles a step; "
          f"kernel {kernel_ms * 1e3 * float(mhz) / t:.0f} SM cycles a step; "
          f"SM clock under the kernel {mhz} MHz (max {max_mhz} MHz)")
    print(f"day_scan plain version: {plain_ms:.1f} ms; bound "
          f"{b_ms:.5f} ms by {b_by}; library call: none")
    print(f"day_scan full-trace mode: {full_ms:.4f} ms at N={n} (bound "
          f"{fb_ms:.5f} ms by {fb_by}), {full_one_ms:.4f} ms at N=1 (bound "
          f"{fb1_ms:.6f} ms by {fb1_by}); default mode {kernel_ms:.4f} / "
          f"{one_ms:.4f} ms; chunk steps {ds.chunk_steps(n_lvl, True)} "
          f"(default {ds.chunk_steps(n_lvl)})")
    print(f"twin warm query: mean {np.mean(q_ms):.2f} ms, min "
          f"{np.min(q_ms):.2f} ms over 10 (first warm {warm_first_ms:.2f} "
          f"ms); what-if (new values: assembly + push + query): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in what_if_ms.items()))
    report, in_query_ms = profile_queries(twin.query, 5)
    print(report)
    if in_query_ms is not None:
        print(f"day_scan inside a warm query (profiler): {in_query_ms:.4f} "
              f"ms; back to back (CUDA events): {kernel_ms:.4f} ms; ratio "
              f"{in_query_ms / kernel_ms:.3f}")
    print(batch_timing(twin) + f"\n  beside the warm serial query: mean "
          f"{np.mean(q_ms):.3f} ms")
    print(steady_state_timing())
    print(gradient_timing(opt["peak_cap_c"]))
    print(fleet_timing())
    del twin
    lm_rows = lm_phases(dev)
    n_tf, err_tf = transformer_phases(dev)
    lm_rows[0]["launches"] += n_tf
    lm_rows[0]["max_abs_err"] = max(lm_rows[0]["max_abs_err"], err_tf)
    n_train, _, bwd_row = training_phases(dev)
    lm_rows[0]["launches"] += n_train
    n_ssd_train, ssd_bwd_row, fa_f, fa_b = ssm_training_phases(dev)
    lm_rows[0]["launches"] += fa_f
    bwd_row["launches"] += fa_b
    lm_rows[1]["launches"] += n_ssd_train
    torch.cuda.empty_cache()
    # 27. gemma3-4b training, 12 layers
    g_f, g_b, gemma_line, gemma_prof = train_gemma3(dev)
    print(gemma_line)
    print(gemma_prof)
    lm_rows[0]["launches"] += g_f
    bwd_row["launches"] += g_b
    torch.cuda.empty_cache()
    # 28. mamba2-2.7b tuned (SSD chunk 128)
    t0 = time.perf_counter()
    n_m_f, n_m_b, err_mf, err_mb, m_row = mamba2_tuned_phases(dev)
    lm_rows[1]["launches"] += n_m_f
    lm_rows[1]["max_abs_err"] = max(lm_rows[1]["max_abs_err"], err_mf)
    ssd_bwd_row["launches"] += n_m_b
    ssd_bwd_row["max_abs_err"] = max(ssd_bwd_row["max_abs_err"], err_mb)
    torch.cuda.empty_cache()
    t28 = time.perf_counter() - t0
    # 29. the perception nets
    t0 = time.perf_counter()
    perception_phase(dev)
    t29 = time.perf_counter() - t0
    # 30. the measured-cell harness
    t0 = time.perf_counter()
    h_ssd, h_f, h_b = harness_phase(dev)
    lm_rows[1]["launches"] += h_ssd
    lm_rows[0]["launches"] += h_f
    bwd_row["launches"] += h_b
    t30 = time.perf_counter() - t0
    print(f"phases 28-30: {t28:.1f} s, {t29:.1f} s, {t30:.1f} s; "
          f"mamba2-2.7b's SSD forward at its prefill shape (chunk "
          f"{TUNED_CHUNK}): {m_row[0]:.4f} ms, plain {m_row[1]:.3f} ms, "
          f"bound {m_row[2]:.5f} ms by {m_row[3]}")
    print(f"flash launches on the main paths: {lm_rows[0]['launches']} "
          f"({lm_rows[0]['launches'] - n_tf - n_train - fa_f - g_f - h_f} "
          f"zamba2-1.2b prefill, {n_tf} transformer family, {n_train} "
          f"training and whisper-medium, {fa_f} zamba2-1.2b training, {g_f} "
          f"gemma3-4b training, {h_f} the harness); flash backward calls "
          f"{bwd_row['launches']} ({fa_b} zamba2-1.2b training, {g_b} "
          f"gemma3-4b training, {h_b} the harness); SSD forward launches "
          f"{lm_rows[1]['launches']} ({n_ssd_train} in phases 24-25, "
          f"{n_m_f} mamba2-2.7b tuned, {h_ssd} the harness); SSD backward "
          f"calls {ssd_bwd_row['launches']} ({n_m_b} mamba2-2.7b tuned)")
    if MISSES:
        fail(f"{len(MISSES)} check(s) outside tolerance: " + "; ".join(MISSES))
    print(json.dumps({"kernels": [{
        "name": "day_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/day_scan.cu",
        "replaces": "src/repro/kernels/day_scan.py:47",
        "launches": launches, "max_abs_err": worst, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}] + lm_rows + [bwd_row, ssd_bwd_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
