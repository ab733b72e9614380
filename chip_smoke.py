#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fmc_uia_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and turned into a
pass):

1. env — the card's name and power limit, and the kernels' build time
   (nvcc, from ``fmc_uia_tpu_torch/csrc``).
2. kernels — each hand-written kernel against its plain PyTorch version on
   the card, in f32 (TF32 off) and bf16, at the swin_b 512² stage shapes of
   a batch of 8 (shifted and unshifted), a padded grid and a window-7 case;
   max error against the stated tolerance (scaled to the branch, not to
   the residual); CUDA-event medians of the kernel, the plain version and
   the bound.
3. model — the flagship 27-task swin_b 512² model (random weights from a
   seed) in bf16 through ``Predictor`` on batches of 8, one task of each
   type; held against the same weights in f32 on the card, and in f32 on
   the CPU for one image; the launch counters must rise by 24 and 4 per
   forward; the host cost of enqueueing one forward, and a
   ``torch.profiler`` table of one forward
   (``chiprun_out/profile_forward.txt``).
4. serving — ``StreamingPredictor(max_batch=8)`` after ``warmup()``
   serves a closed loop of 64 outstanding requests, round-robin over the
   4 task types, for at least 10 s, three times; every result is held
   against ``Predictor``; per run img/s, p50/p99 and the dispatch stats,
   and their median and spread over the runs. The launch counters are
   zeroed just before the first request and read just after the last:
   this is the main path's count.

The line before the card's name is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Per-case numbers also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12    # H100 SXM HBM3 bytes/s
BATCH = 8            # the serving path's largest micro-batch
IMAGE = 512
SERVE_RUNS = 3       # serving runs, each of at least SERVE_S seconds
SERVE_S = 10.0
OUTSTANDING = 64     # requests kept in flight by the closed loop


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(v, 1e-30))) - 7)


def check_branch(out, ref, x, dtype, what):
    """Hold a kernel's ``x + dp*y`` against its plain version's.

    Wherever y differs at all, the final rounding of the sum may fall one
    ulp of the output apart, so each element may differ by one ulp of its
    own magnitude plus a tolerance scaled to the branch (max |ref - x|,
    the largest dp*y), not to the residual x: f32 1e-4 of it (f32 sums of
    up to 4C products in another order); bf16 4 bf16 ulps of it (y and
    dp*y are each rounded once, at most an ulp apart, and the f32 sums
    behind them differ by far less). Returns a record of the check."""
    import torch

    out, ref, x = out.float(), ref.float(), x.float()
    branch = float((ref - x).abs().max())
    bits = 7 if dtype == torch.bfloat16 else 23
    mag = torch.maximum(out.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    diff = (out - ref).abs()
    excess = float((diff - ulp).max())
    tol = (4 * bf16_ulp(branch) if dtype == torch.bfloat16
           else 1e-4 * branch)
    if not excess <= tol:
        fail(f"{what} {dtype}: error beyond one output ulp {excess:.3e} > "
             f"tol {tol:.3e} (branch max {branch:.3e})")
    return dict(max_abs_err=float(diff.max()), branch_max=branch,
                excess_err=excess, tol=tol)


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------
def attn_cases():
    """(label, B, grid, C, heads, ws, shift) — the four swin_b 512² stage
    shapes, unshifted and shifted (stage 3's 16² grid > 8 shifts too),
    a padded grid (12 -> 16) and a window-7 case."""
    cases = []
    for s, (g, c, h) in enumerate(((128, 128, 4), (64, 256, 8),
                                   (32, 512, 16), (16, 1024, 32))):
        for shift in (0, 4):
            cases.append((f"stage{s}{'_shift' if shift else ''}", BATCH, g,
                          c, h, 8, shift))
    cases.append(("pad12_shift", 2, 12, 128, 4, 8, 4))
    cases.append(("ws7_shift", 2, 56, 96, 3, 7, 3))
    return cases


def attn_inputs(B, grid, C, H, ws, shift, dtype, gen, dev):
    import numpy as np
    import torch

    from fmc_uia_tpu_torch.models.encoders.swin import (
        _relative_position_index,
        block_attn_mask,
    )

    hp = -(-grid // ws) * ws
    N = ws * ws

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x = rnd(B, hp, hp, C).to(dtype)
    table = rnd((2 * ws - 1) ** 2, H, std=0.02)
    idx = torch.as_tensor(_relative_position_index(ws).reshape(-1))
    bias = table[idx.to(dev)].reshape(N, N, H).permute(2, 0, 1).contiguous()
    m = block_attn_mask(grid, grid, ws, shift)
    mask = None if m is None else torch.as_tensor(m, device=dev)
    dp = torch.ones(B, device=dev)
    dp[0] = 0.5  # one sample with a drop-path scale != 1
    w = dict(ln_scale=1 + rnd(C, std=0.1), ln_bias=rnd(C, std=0.1),
             wqkv=rnd(3 * C, C, std=C ** -0.5), bqkv=rnd(3 * C, std=0.02),
             wproj=rnd(C, C, std=C ** -0.5), bproj=rnd(C, std=0.02),
             bias_hnn=bias)
    return x, w, mask, dp, np.prod((B, hp, hp)), hp


def mlp_inputs(B, grid, C, dtype, gen, dev):
    import torch

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x = rnd(B, grid, grid, C).to(dtype)
    dp = torch.ones(B, device=dev)
    dp[0] = 0.5
    w = dict(ln_scale=1 + rnd(C, std=0.1), ln_bias=rnd(C, std=0.1),
             w1=rnd(4 * C, C, std=C ** -0.5), b1=rnd(4 * C, std=0.02),
             w2=rnd(C, 4 * C, std=(4 * C) ** -0.5), b2=rnd(C, std=0.02))
    return x, w, dp


def err_text(chk) -> str:
    return (f"err {chk['max_abs_err']:.3e} (beyond 1 ulp "
            f"{chk['excess_err']:.3e} <= tol {chk['tol']:.3e}; branch max "
            f"{chk['branch_max']:.3f})")


def check_kernels(dev, records):
    import torch

    from fmc_uia_tpu_torch.ops import swin_block as sb

    gen = torch.Generator().manual_seed(0)
    summary = {"attention_branch": [], "mlp_branch": []}
    for label, B, grid, C, H, ws, shift in attn_cases():
        for dtype in (torch.float32, torch.bfloat16):
            x, w, mask, dp, T, hp = attn_inputs(B, grid, C, H, ws, shift,
                                                dtype, gen, dev)
            args = (w["ln_scale"], w["ln_bias"], w["wqkv"], w["bqkv"],
                    w["wproj"], w["bproj"], w["bias_hnn"], mask, H)
            out = sb.attention_branch(x, *args, dp=dp)
            ref = sb.attention_branch_reference(x, *args, dp=dp)
            chk = check_branch(out, ref, x, dtype, f"attention_branch {label}")
            N = ws * ws
            esz = x.element_size()
            flops = 2 * T * C * 3 * C + 2 * T * C * C + 4 * T * N * C
            nbytes = (2 * T * C * esz + 4 * (4 * C * C + 6 * C)
                      + 4 * H * N * N
                      + (0 if mask is None else 4 * mask.numel()))
            rec = dict(kernel="attention_branch", case=label,
                       dtype=str(dtype).split(".")[-1],
                       shape=[B, hp, hp, C], heads=H, ws=ws,
                       mask=mask is not None, **chk)
            if dtype == torch.bfloat16 or label.startswith("stage"):
                peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
                rec["ms"] = cuda_ms(lambda: sb.attention_branch(x, *args,
                                                                dp=dp))
                rec["plain_ms"] = cuda_ms(
                    lambda: sb.attention_branch_reference(x, *args, dp=dp),
                    reps=20, warmup=1)
                rec["bound_ms"] = 1e3 * max(flops / peak, nbytes / HBM_BPS)
                rec["bound_by"] = ("operations" if flops / peak
                                   >= nbytes / HBM_BPS else "bytes")
            records.append(rec)
            log(f"  K1f {label:12s} {rec['dtype']:8s} {rec['shape']} "
                + err_text(chk)
                + (f"  {rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f}, "
                   f"bound {rec['bound_ms']:.4f})" if "ms" in rec else ""))
            if dtype == torch.bfloat16 and label.startswith("stage"):
                summary["attention_branch"].append(rec)
    for s, (grid, C) in enumerate(((128, 128), (64, 256))):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dp = mlp_inputs(BATCH, grid, C, dtype, gen, dev)
            args = (w["ln_scale"], w["ln_bias"], w["w1"], w["b1"], w["w2"],
                    w["b2"])
            out = sb.mlp_branch(x, *args, dp=dp)
            ref = sb.mlp_branch_reference(x, *args, dp=dp)
            chk = check_branch(out, ref, x, dtype, f"mlp_branch stage{s}")
            T = BATCH * grid * grid
            esz = x.element_size()
            flops = 16 * T * C * C
            nbytes = 2 * T * C * esz + 4 * (8 * C * C + 7 * C)
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
            rec = dict(kernel="mlp_branch", case=f"stage{s}",
                       dtype=str(dtype).split(".")[-1],
                       shape=[BATCH, grid, grid, C], **chk,
                       ms=cuda_ms(lambda: sb.mlp_branch(x, *args, dp=dp)),
                       plain_ms=cuda_ms(
                           lambda: sb.mlp_branch_reference(x, *args, dp=dp),
                           reps=20, warmup=1),
                       bound_ms=1e3 * max(flops / peak, nbytes / HBM_BPS),
                       bound_by=("operations" if flops / peak
                                 >= nbytes / HBM_BPS else "bytes"))
            records.append(rec)
            log(f"  K2f stage{s}       {rec['dtype']:8s} {rec['shape']} "
                + err_text(chk) + f"  {rec['ms']:.3f} ms (plain "
                f"{rec['plain_ms']:.3f}, bound {rec['bound_ms']:.4f})")
            if dtype == torch.bfloat16:
                summary["mlp_branch"].append(rec)
    return summary


# ---------------------------------------------------------------------------
# phase 3/4: model and serving
# ---------------------------------------------------------------------------
def near_tie_ok(pred, ref_logits, err, ncls):
    """Decoded ids may differ from the reference's argmax only where the
    reference's top-2 margin is within 2*err (the largest logit error):
    returns (n_disagree, n_near_tie)."""
    import torch

    lg = ref_logits[..., :ncls].float()
    top2 = torch.topk(lg, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ref_ids = lg.argmax(-1)
    bad = (pred.to(ref_ids.device) != ref_ids)
    near = margin <= 2 * err
    if bool((bad & ~near).any()):
        fail(f"{int((bad & ~near).sum())} decoded ids differ away from a "
             f"near tie (2*err = {2 * err:.3e})")
    return int(bad.sum()), int(near.sum())


def compare_models(pred_model, ref_model, x_pre, spec, rel_tol, what):
    """Raw outputs of two models on the same input, within rel_tol of the
    reference's largest magnitude; returns (ref raw output, max err)."""
    import torch

    with torch.inference_mode():
        a = pred_model(x_pre.to(next(pred_model.parameters()).device),
                       spec.task_name, spec.global_index)
        b = ref_model(x_pre.to(next(ref_model.parameters()).device),
                      spec.task_name, spec.global_index)
    if isinstance(b, dict):
        errs = {}
        for k in b:
            d = float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
            top = float(b[k].float().abs().max())
            errs[k] = d
            if not d <= rel_tol * max(top, 1e-3):
                fail(f"{what} {spec.task_id} {k}: err {d:.3e} > "
                     f"{rel_tol} x {top:.3e}")
        return {k: v.float().cpu() for k, v in b.items()}, errs
    d = float((a.float().cpu() - b.float().cpu()).abs().max())
    top = float(b.float().abs().max())
    if not d <= rel_tol * max(top, 1e-3):
        fail(f"{what} {spec.task_id}: err {d:.3e} > {rel_tol} x {top:.3e}")
    return b.float().cpu(), d


def serve_closed_loop(svc, pool, tids):
    """Keep OUTSTANDING requests in flight (request k sends pool image
    k % len(pool)), submitting one as each completes, for SERVE_S
    seconds; then drain. Returns (completed, wall s, [(task id, latency
    ms)], [(pool index, result)])."""
    from concurrent.futures import FIRST_COMPLETED, wait

    lat, results, pending = [], [], {}
    k = 0

    def submit():
        nonlocal k
        j = k % len(pool)
        k += 1
        ts = time.perf_counter()
        f = svc.submit(pool[j], tids[j])
        # the completer thread fulfils the future; time it there
        f.add_done_callback(lambda _f, ts=ts, tid=tids[j]: lat.append(
            (tid, 1e3 * (time.perf_counter() - ts))))
        pending[f] = j

    t0 = time.perf_counter()
    while len(pending) < OUTSTANDING:
        submit()
    while pending:
        done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
        for f in done:
            results.append((pending.pop(f), f.result()))
            if time.perf_counter() - t0 < SERVE_S:
                submit()
    wall = time.perf_counter() - t0
    while len(lat) < len(results):  # the last callbacks may still run
        time.sleep(1e-3)
    return len(results), wall, lat, results


def check_served(results, refs, tids, registry) -> None:
    """Every served result against Predictor's on the same image: ids
    equal except a few seg pixels (another batch grouping or padded size
    may pick another cuDNN algorithm), boxes/points within 2e-2."""
    import numpy as np

    seg_agree, seg_n = 0.0, 0
    for j, got in results:
        ref = refs[j]
        kind = registry[tids[j]].task_name
        if kind == "segmentation":
            seg_agree += float((got == ref).mean())
            seg_n += 1
        elif kind == "classification":
            if not np.array_equal(got, ref):
                fail(f"serving {tids[j]}: class id differs from Predictor")
        elif not np.allclose(got, ref, atol=2e-2):
            fail(f"serving {tids[j]}: max diff {np.abs(got - ref).max()}")
    if seg_n and seg_agree / seg_n < 0.999:
        fail(f"serving: seg masks agree on {seg_agree / seg_n:.5f} < 0.999")


def profile_forward(pred, imgs, tid, out_dir, report) -> None:
    """Host cost of enqueueing one forward with the GPU idle, and the
    host-side op table of one synced forward (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = pred.predict_device(imgs, tid)
        enq.append(1e3 * (time.perf_counter() - t0))
        dev.cpu()
    enq.sort()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.predict_images(imgs, tid)
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cpu_time_total", row_limit=40)
    with open(os.path.join(out_dir, "profile_forward.txt"), "w") as f:
        f.write(table)
    watch = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::item",
             "aten::_local_scalar_dense", "cudaHostAlloc", "cudaMalloc",
             "cudaFuncSetAttribute", "cudaLaunchKernel", "cudaMemcpyAsync")
    counts = {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 3)]
              for e in avg if e.key in watch}
    n_ops = sum(e.count for e in avg if e.key.startswith("aten::"))
    report["profile"] = {"enqueue_ms_idle_gpu": enq, "calls": counts,
                         "aten_ops": n_ops}
    log(f"[profile] enqueue of one B={BATCH} forward with the GPU idle: "
        f"median {enq[2]:.2f} ms; {n_ops} aten ops; [count, self ms]: "
        f"{counts}")
    for line in table.splitlines()[:16]:
        log("  " + line)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU; nothing to drive",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "fmc_uia_tpu_torch")):
        print("chip_smoke: fmc_uia_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.flagship import SERVING_TASKS, flagship_config_dict
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.ops import build
    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.ops.image import normalize_images
    from fmc_uia_tpu_torch.serving import StreamingPredictor
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {"device": name, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # -- 1. env + build ------------------------------------------------------
    log(f"[env] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    spent = build.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.1f} s wall; per library "
        f"{ {k: round(v, 1) for k, v in spent.items()} }")
    for k in build.KERNELS:
        for line in build.ptxas_report(k).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k}: {line.strip()}")

    # -- 2. kernels ------------------------------------------------------------
    log("[kernels] kernel vs plain version on the card")
    records = []
    summary = check_kernels(dev, records)
    report["kernel_cases"] = records

    # -- 3. model --------------------------------------------------------------
    cfg = Config(config_dict=flagship_config_dict())
    registry = TaskRegistry.from_config(cfg)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    t0 = time.perf_counter()
    model = build_model(cfg, registry, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] flagship swin_b {IMAGE}² 27 tasks, {n_params / 1e6:.1f} M "
        f"params, built in {time.perf_counter() - t0:.1f} s")
    pred = Predictor(model, registry, mean, std, IMAGE, device="cuda")
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)
    for tid in SERVING_TASKS:  # first use: allocator, cuDNN heuristics
        pred.predict_images(imgs, tid)
    torch.cuda.synchronize()
    sb.attention_branch.launches = 0
    sb.mlp_branch.launches = 0
    outs = {}
    t0 = time.perf_counter()
    for tid in SERVING_TASKS:
        outs[tid] = pred.predict_images(imgs, tid)
    fwd_s = (time.perf_counter() - t0) / len(SERVING_TASKS)
    n = len(SERVING_TASKS)
    got = (sb.attention_branch.launches, sb.mlp_branch.launches)
    log(f"[model] {n} Predictor forwards at B={BATCH}: launches "
        f"attention_branch {got[0]}, mlp_branch {got[1]}; "
        f"{1e3 * fwd_s:.1f} ms per forward (host clock, synced)")
    if got != (24 * n, 4 * n):
        fail(f"launch counters {got} != {(24 * n, 4 * n)}")
    report["model"] = {"params_M": n_params / 1e6, "fwd_ms_b8":
                       1e3 * fwd_s, "launches": got}

    # same weights in f32 on the card, and in f32 on the CPU for one image
    model32 = build_model(cfg, registry, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    x_pre = normalize_images(torch.from_numpy(imgs), mean, std)
    model_cpu = build_model(cfg, registry, dtype=torch.float32,
                            device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    cmp = {}
    for tid in SERVING_TASKS:
        spec = registry[tid]
        ncls = spec.num_classes
        # bf16 vs f32 on the card, B = 8: the raw outputs within 10% of the
        # largest magnitude (bf16 keeps 8 bits through ~30 layers), the
        # decoded outputs equal except at near ties of the f32 reference
        ref, err = compare_models(model, model32, x_pre, spec, 0.1,
                                  "bf16 vs f32")
        # f32 on the card vs f32 on the CPU, B = 1: within 1e-3 of the
        # largest magnitude (kernel sums in another order, cuDNN vs CPU
        # convolutions, TF32 off)
        ref1, err1 = compare_models(model32, model_cpu, x_pre[:1], spec,
                                    1e-3, "f32 card vs f32 cpu")
        p = torch.from_numpy(outs[tid])
        if spec.task_name in ("segmentation", "classification"):
            bad, near = near_tie_ok(p, ref, err, ncls)
            entry = {"bf16_vs_f32_err": err, "disagree": bad,
                     "near_ties": near}
        elif spec.task_name == "detection":
            entry = {"bf16_vs_f32_err": err}
        else:
            d = float((p - ref).abs().max())
            entry = {"bf16_vs_f32_err": err, "decoded_err": d}
        entry["f32_card_vs_cpu_err"] = err1
        cmp[tid] = entry
        log(f"  {tid:20s} {entry}")
    report["model"]["compare"] = cmp
    del model32, model_cpu
    torch.cuda.empty_cache()

    profile_forward(pred, imgs, SERVING_TASKS[0], out_dir, report)

    # -- 4. serving ------------------------------------------------------------
    svc = StreamingPredictor(model, registry, mean, std, IMAGE,
                             max_batch=BATCH, max_delay_ms=5.0,
                             device="cuda")
    t0 = time.perf_counter()
    svc.warmup(task_ids=list(SERVING_TASKS))
    log(f"[serving] warmup of chain {svc._chain} x 4 types: "
        f"{time.perf_counter() - t0:.1f} s")
    # a pool of 64 request images; image j always goes with task j % 4, so
    # every result has one Predictor reference (batches of 8 per task)
    pool = rng.randint(0, 256, (OUTSTANDING, IMAGE, IMAGE, 3)).astype(
        np.uint8)
    tids = [SERVING_TASKS[j % 4] for j in range(OUTSTANDING)]
    refs = [None] * OUTSTANDING
    for tid in SERVING_TASKS:
        idx = [j for j in range(OUTSTANDING) if tids[j] == tid]
        for k in range(0, len(idx), BATCH):
            out = pred.predict_images(pool[idx[k:k + BATCH]], tid)
            for j, res in zip(idx[k:k + BATCH], out):
                refs[j] = res
    torch.cuda.synchronize()
    sb.attention_branch.launches = 0
    sb.mlp_branch.launches = 0
    runs, dispatches = [], 0
    for r in range(SERVE_RUNS):
        before = dict(svc.stats, by_size=dict(svc.stats["by_size"]))
        n_done, wall, lat, results = serve_closed_loop(svc, pool, tids)
        stats = {k: svc.stats[k] - before[k]
                 for k in ("dispatches", "pad_images")}
        stats["by_size"] = {k: v - before["by_size"].get(k, 0)
                            for k, v in svc.stats["by_size"].items()}
        dispatches += stats["dispatches"]
        check_served(results, refs, tids, registry)
        ms = [v for _, v in lat]
        by_task = {tid: [round(float(np.percentile(
            [v for t, v in lat if t == tid], q)), 1) for q in (50, 99)]
            for tid in SERVING_TASKS}
        run = {"requests": n_done, "wall_s": wall, "img_s": n_done / wall,
               "p50_ms": float(np.percentile(ms, 50)),
               "p99_ms": float(np.percentile(ms, 99)),
               "p50_p99_ms_by_task": by_task, "stats": stats}
        runs.append(run)
        log(f"[serving] run {r}: {n_done} requests in {wall:.2f} s: "
            f"{run['img_s']:.2f} img/s, e2e p50 {run['p50_ms']:.1f} ms, "
            f"p99 {run['p99_ms']:.1f} ms, [p50, p99] ms by task {by_task},"
            f" stats {stats}")
    launches = {"attention_branch": sb.attention_branch.launches,
                "mlp_branch": sb.mlp_branch.launches}
    svc.close()
    if (launches != {"attention_branch": 24 * dispatches,
                     "mlp_branch": 4 * dispatches} or dispatches == 0):
        fail(f"serving launches {launches} != 24/4 x {dispatches} "
             "dispatches")
    summ = {k: {"median": float(np.median([u[k] for u in runs])),
                "min": min(u[k] for u in runs),
                "max": max(u[k] for u in runs)}
            for k in ("img_s", "p50_ms", "p99_ms")}
    log(f"[serving] {SERVE_RUNS} runs of >= {SERVE_S:.0f} s, {OUTSTANDING} "
        f"outstanding: img/s median {summ['img_s']['median']:.2f}"
        f" (min {summ['img_s']['min']:.2f}, max {summ['img_s']['max']:.2f});"
        f" p50 ms median {summ['p50_ms']['median']:.1f}; p99 ms median "
        f"{summ['p99_ms']['median']:.1f} (min {summ['p99_ms']['min']:.1f}, "
        f"max {summ['p99_ms']['max']:.1f}); launches {launches} over "
        f"{dispatches} dispatches | {name} | {smi}")
    report["serving"] = {"runs": runs, "summary": summ,
                         "outstanding": OUTSTANDING, "launches": launches,
                         "max_batch": BATCH}

    # -- kernels line ----------------------------------------------------------
    def entry(kname, source, replaces):
        recs = summary[kname]
        # per flagship forward at B=8: stage shapes weighted by the blocks
        # that run them (attention: 2/2/18/2 blocks, half shifted; MLP:
        # stages 0 and 1, 2 blocks each)
        if kname == "attention_branch":
            weights = {"stage0": 1, "stage0_shift": 1, "stage1": 1,
                       "stage1_shift": 1, "stage2": 9, "stage2_shift": 9,
                       "stage3": 1, "stage3_shift": 1}
        else:
            weights = {"stage0": 2, "stage1": 2}
        tot = {k: sum(weights[r["case"]] * r[k] for r in recs)
               for k in ("ms", "plain_ms", "bound_ms")}
        by = {r["bound_by"] for r in recs}
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": "operations" if "operations" in by else "bytes",
                "library_ms": None}

    kernels = [
        entry("attention_branch", "fmc_uia_tpu_torch/csrc/swin_attn_fwd.cu",
              "fmc_uia_tpu/ops/swin_block_pallas.py:480"),
        entry("mlp_branch", "fmc_uia_tpu_torch/csrc/swin_mlp_fwd.cu",
              "fmc_uia_tpu/ops/swin_block_pallas.py:761"),
    ]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['total_s']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
