"""End-to-end benchmark of the port: online detection + fusion FPS at CA-1M
scale, on one card.

Port of the JAX package's ``bench.py``.  A parent process that does no device
work drives a sequence of measurement PHASES, each in its own subprocess
(``python -m boxfusion_tpu_torch.bench --phase NAME --out PATH --budget S
--device D``) under its own timeout, in the JAX bench's order:

  micro       -- CuTR-768 bf16 forward: ms, FLOPs (``FlopCounterMode``),
                 TFLOP/s, MFU against the card's table peak
                 (``_chip_peak_tflops``) and against a bf16 matmul ceiling
                 measured on the same card.
  headline    -- the real path (the RECORD): posed RGB-D stream at CA-1M
                 resolution (512x384), keyframe gap 20; per keyframe ONE
                 upload into ``FusedDevicePipeline``: CuTR RGB-D detection,
                 open-vocab CLIP ViT-L/14 labels, device-resident association
                 and the 1024-particle multi-view PST fusion step.  Random
                 weights from a seed, a synthetic stream made on the host.
                 Sized NOT to saturate (2048-slot world, 128-crop label
                 budget), which the end-of-phase world export checks
                 (``headline_saturated``).  Also the gap-1 live-SLAM profile,
                 the I/O-inclusive figure (the same pipeline fed from an
                 on-disk CA-1M layout through ``CA1MDataset`` and
                 ``Prefetcher``) and the chunk-8 throughput mode.
  multistream -- 4 sequences in lockstep on one card (``BatchedPipeline``,
                 packed transport, labelled): aggregate frames/s.
  stages      -- per-stage keyframe costs (``stage_ms``): the CLIP tower at
                 each label bucket, crop + resize, the association step with
                 fusion on and off on the oracle load, and their difference.
  stress      -- the oracle load at the 256-slot profile (saturating on
                 purpose), a real CuTR forward enqueued per keyframe.

Each phase writes its figures to its JSON file as it measures them; the
parent merges them and prints the record so far as ONE JSON line after
every phase.  The last stdout line is the record (the phases' own output
goes to stderr).  Files go under ``results/bench_torch/``.  The whole bench
runs under a deadline (``BENCH_DEADLINE_S``, default 1500 s); a phase that
would start too late is skipped and named under ``skipped_phases``, and a
secondary figure that the headline's budget leaves out under
``skipped_figures``; a phase that raises, exits non-zero or times out is
named under ``failed_phases``, and the bench then exits non-zero.  Each
phase function also takes ``wl``, a workload other than ``_workload``'s, for
a caller that runs the phases in its own process at a cut depth.

MEASUREMENT PROTOCOL.  PyTorch returns from a launch before the card has
run it, so a host clock read right after a loop of launches measures how
fast the host enqueues work, not how fast the card does it.  Every timed
window therefore starts after a warm-up that ends in a synchronise (so no
earlier work is still running into it) and ends with ``sync`` (a
``torch.cuda.synchronize``) INSIDE the window, so all the work it launched
has finished when the clock stops.  No figure counts the kernels' build:
each phase builds them (or finds them built) during its warm-up.

vs_baseline: the reference publishes no FPS (BASELINE.md); the paper-level
claim for the CUDA pipeline is ~10 FPS end-to-end on a desktop GPU, dataset
I/O included, so vs_baseline = value / 10.0 is an ESTIMATE.

With ``--device cpu`` every phase runs at the JAX bench's CPU sizes
(CuTR-192 float32, 256 px, a toy CLIP tower) through the plain PyTorch
versions of the kernels; those figures are CPU figures, and the record says
so.  Without a card and without ``--device cpu`` the bench refuses to start.

    python -m boxfusion_tpu_torch.bench
    python -m boxfusion_tpu_torch.bench --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from boxfusion_tpu_torch.tools.common import REPO, lift_class_bias, sync, tool_config
from boxfusion_tpu_torch.utils.device import resolve_device

RESULTS = os.path.join(REPO, "results", "bench_torch")
HEADLINE_CAPACITY = 2048  # world slots on the card (256 on the CPU)


_T0 = time.monotonic()


def _log(msg: str) -> None:
    print(f"bench[{time.monotonic() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _write_json(path: str, d: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(d) + "\n")
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# shared measurement setup (the phases and the tools build from these)
# ---------------------------------------------------------------------------

# Dense bf16 tensor-core peaks in TFLOP/s by device-name substring (NVIDIA
# H100 Tensor Core GPU datasheet: SXM5 989.4, PCIe 756, NVL 835; the SXM
# part names itself "NVIDIA H100 80GB HBM3").  A card not listed gets no
# peak, and its MFU is null.
_PEAK_TFLOPS = (
    ("h100 nvl", 835.0),
    ("h100 pcie", 756.0),
    ("h100 sxm", 989.4),
    ("h100 80gb hbm3", 989.4),
)


def _chip_peak_tflops(device: torch.device) -> tuple:
    """(dense bf16 peak TFLOP/s or None, the device's name)."""
    if device.type != "cuda":
        return None, "cpu"
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAK_TFLOPS:
        if key in name.lower():
            return peak, name
    return None, name


def _flops(fn, *args) -> float:
    """FLOPs of one ``fn(*args)``, counted by ``FlopCounterMode`` from the
    aten products it dispatches (matmuls, convolutions, attention).  Work
    inside the port's own CUDA kernels is not counted: ``FlopCounterMode``
    does not see a ctypes launch.  CuTR's backbone runs plain attention by
    default (``CuTRConfig.attn_impl="xla"``), so its count is whole; never
    count a model built with ``attn_impl="kernel"``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def _workload(on_card: bool) -> dict:
    return dict(
        dim=768 if on_card else 192,
        S=512 if on_card else 256,
        r=1 if on_card else 4,
        n_frames=400 if on_card else 40,
        gap=20,
        n_runs=3 if on_card else 2,
        dtype_tag="bf16" if on_card else "f32",
    )


def _bench_batch(device: torch.device, wl: dict):
    """The detector microbench's ``FrameBatch``: ``RandomState(0)`` noise at
    the workload's pad size."""
    from boxfusion_tpu_torch.models.cutr import FrameBatch

    S, r = wl["S"], wl["r"]
    rng = np.random.RandomState(0)
    f = 0.6 * S
    arrays = dict(
        image=rng.randn(1, S, S, 3),
        depth=rng.randn(1, S // r, S // r, 1),
        K=[[[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]]],
        image_hw=[[0.75 * S, S]],
        depth_params=[[2.0, 0.5]],
        T_gravity=np.eye(3)[None],
    )
    return FrameBatch(**{k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in arrays.items()})


def _build_model(device: torch.device, wl: dict, flax_params=None):
    """(CuTR, the bench batch): random weights from seed 0, or
    ``flax_params`` (the JAX model's, carried over through
    ``models/cutr/convert.py:from_flax_params``), then the class-head bias
    calibrated so the association, fusion and label stages see a realistic
    detection load: random logits sit near the focal prior (scores ~0.02),
    so no detection would pass the 0.3 filter; +3.2 on every class head puts
    a heavy load above it.  The FLOPs are unchanged."""
    from boxfusion_tpu_torch.models.cutr import make_cutr
    from boxfusion_tpu_torch.models.cutr.convert import from_flax_params

    model = make_cutr(wl["dim"], depth_model=True, device=device, seed=0,
                      dtype="bfloat16" if wl["dtype_tag"] == "bf16" else "float32")
    if flax_params is not None:
        model.load_state_dict(from_flax_params(flax_params), strict=True)
    lift_class_bias(model, 3.2)
    return model, _bench_batch(device, wl)


def _bench_cfg(on_card: bool, wl: dict):
    """config/ca1m.yaml at the tools' oracle load (filter 0.3, no uv bound or
    floor mask, a synthesized PST); on the CPU a smaller search."""
    c = tool_config(wl["gap"])
    if not on_card:
        c["box_fusion"]._data["pst_size"] = 256
        c["box_fusion"]._data["max_fusions_per_frame"] = 4
        c["association"]._data["max_views"] = 5
    return c


def _headline_cfg(on_card: bool, wl: dict):
    """``_bench_cfg`` with the headline's non-saturating label budget and
    observation bank on the card."""
    cfg = _bench_cfg(on_card, wl)
    if on_card:
        cfg["detection"]._data["max_label_boxes"] = 128
        cfg["association"]._data["max_observations"] = 16384
    return cfg


def _make_labeler(on_card: bool, device: torch.device, width: int = 1024, layers: int = 24):
    """The CLIP image tower with 473 random text features (``RandomState(1)``).

    On the card ViT-L/14 (the reference fork's image model): bf16,
    quick-GELU (OpenAI's ViT-L/14 is a quick-GELU model), attention through
    ``whole_seq_attention`` (``attn_impl`` "auto").  ``width`` and
    ``layers`` narrow and shorten that tower (heads of 64 channels) for the
    tools at toy size.  ``on_card=False``: the JAX bench's toy tower (8
    classes, 32-wide features)."""
    from boxfusion_tpu_torch.models.clip import CLIPConfig, OpenVocabLabeler

    if on_card:
        clip_cfg = CLIPConfig(patch=14, width=width, layers=layers, heads=max(width // 64, 1),
                              embed_dim=width, dtype="bfloat16", quick_gelu=True)
        n_classes, feat_dim = 473, width
    else:
        clip_cfg = CLIPConfig(patch=32, width=64, layers=2, heads=2, embed_dim=32, vocab_size=64,
                              context_length=8, text_width=64, text_layers=1, text_heads=2)
        n_classes, feat_dim = 8, 32
    text_features = np.random.RandomState(1).randn(n_classes, feat_dim).astype(np.float32)
    classes = [f"class{i}" for i in range(n_classes)]
    return OpenVocabLabeler(classes, text_features, cfg=clip_cfg, device=device).init_random(0)


def _frames(wl: dict):
    """(sequence, its frames as a list): synthesis is not pipeline work."""
    from boxfusion_tpu_torch.tools.common import keyframes

    seq, frames, _ = keyframes(wl["n_frames"], wl["S"], wl["gap"])
    return seq, frames


def _phase_init(device):
    dev = resolve_device(device)
    return dev, dev.type == "cuda"


# ---------------------------------------------------------------------------
# phase: micro (detector microbench + measured matmul ceiling)
# ---------------------------------------------------------------------------

def _measure_matmul_peak(device: torch.device) -> tuple:
    """Achieved bf16 matmul TFLOP/s on this card: a chain of large square
    products (``torch.matmul``, a probe of the card, not a port of any
    kernel) with a data dependency between every product and every call,
    warmed up and closed by a synchronise inside the window.  A cheap O(n^2)
    renormalisation per step keeps the values finite without touching the
    O(n^3) term.  MFU is also reported against THIS number
    (detector_mfu_vs_measured_peak)."""
    on_card = device.type == "cuda"
    n, inner, reps = (8192, 8, 10) if on_card else (512, 2, 2)
    dt = torch.bfloat16 if on_card else torch.float32
    rng = np.random.RandomState(7)
    w = torch.as_tensor(rng.randn(n, n).astype(np.float32) / np.sqrt(n), device=device).to(dt)
    x0 = torch.as_tensor(rng.randn(n, n).astype(np.float32), device=device).to(dt)

    def chain(x):
        for _ in range(inner):
            y = x @ w
            x = (y * (1.0 / (y.abs().max().float() + 1e-6))).to(dt)
        return x

    x = chain(x0)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = chain(x)
    sync(device)
    elapsed = time.perf_counter() - t0
    return reps * inner * 2.0 * float(n) ** 3 / elapsed / 1e12, n, inner


def _chained_forward(model, batch):
    """One CuTR forward whose input depends on the previous call's output
    (the JAX bench's ``chained``): the dependency scalar folds in EVERY
    output, and the +1e-3 keeps each call's input unique."""
    def chained(eps):
        out = model(dataclasses.replace(batch, image=batch.image + eps))
        dep = sum(v.float().sum() for v in out.values())
        return dep * 1e-12 + eps + 1e-3

    return chained


def phase_micro(out_path: str, budget_s: float, device=None, wl=None) -> None:
    dev, on_card = _phase_init(device)
    wl = wl or _workload(on_card)
    result = {"on_card": on_card}
    _write_json(out_path, result)

    _log(f"micro: building CuTR-{wl['dim']} ({wl['dtype_tag']})")
    model, batch = _build_model(dev, wl)
    chained = _chained_forward(model, batch)
    reps = 50 if on_card else 3
    with torch.inference_mode():
        eps = chained(torch.zeros((), device=dev))
        sync(dev)
        _log("micro: warm; timing")
        t0 = time.perf_counter()
        for _ in range(reps):
            eps = chained(eps)
        sync(dev)  # inside the window
        det_ms = (time.perf_counter() - t0) / reps * 1e3
        _log(f"micro: detector {det_ms:.2f} ms/forward; counting FLOPs")
        det_flops = _flops(chained, torch.zeros((), device=dev))
    tflops_per_s = det_flops / (det_ms * 1e-3) / 1e12
    peak, chip = _chip_peak_tflops(dev)
    mfu = tflops_per_s / peak if peak else None
    result.update(
        {
            # PRELIMINARY record in case the headline never lands: the
            # detector-only figure.  Overwritten by the headline phase.
            "metric": (
                f"CuTR-{wl['dim']} {wl['dtype_tag']} detector forward @ {wl['S']}px "
                "(PRELIMINARY -- headline e2e FPS pending)"
            ),
            "value": round(1000.0 / det_ms, 3),
            "unit": "forwards/s",
            "vs_baseline": round((1000.0 / det_ms) / 10.0, 3),
            "detector_ms": round(det_ms, 3),
            "detector_gflops": round(det_flops / 1e9, 1),
            "detector_tflops_per_s": round(tflops_per_s, 2),
            "detector_mfu": None if mfu is None else round(mfu, 4),
            "chip": chip,
            "chip_peak_tflops_bf16": peak,
        }
    )
    _write_json(out_path, result)

    _log("micro: probing the measured matmul ceiling")
    with torch.inference_mode():
        measured_peak, probe_n, probe_inner = _measure_matmul_peak(dev)
    result.update(
        {
            "measured_peak_tflops_bf16_matmul": round(measured_peak, 2),
            "matmul_probe_shape": f"{probe_n}x{probe_n}x{probe_n} x{probe_inner}",
            "detector_mfu_vs_measured_peak": round(tflops_per_s / measured_peak, 4),
        }
    )
    _write_json(out_path, result)
    if mfu is not None and mfu > 1.05:
        raise RuntimeError(f"detector {tflops_per_s:.0f} TFLOP/s exceeds the {peak:.0f} TFLOP/s bf16 table "
                           f"peak of '{chip}': a timed window did not wait for the card")
    _log(f"micro: done ({det_ms:.2f} ms, {tflops_per_s:.2f} TFLOP/s, ceiling {measured_peak:.1f})")


# ---------------------------------------------------------------------------
# phase: headline (+ gap=1 + io-inclusive + chunk=8 + stats export)
# ---------------------------------------------------------------------------

def _timed_run(pipe, frames, gap: int) -> float:
    """Frames/s of one ``run`` from a fresh state, the card synchronised
    inside the window."""
    pipe.reset()
    t0 = time.perf_counter()
    pipe.run(frames, gap=gap, export=False)
    sync(pipe.device)
    return len(frames) / (time.perf_counter() - t0)


def _warm(pipe, frames, gap: int) -> None:
    """Run the keyframes of ``frames`` (every gap-th), then wait for the card."""
    for i, frame in enumerate(frames):
        if i % gap == 0:
            pipe.process_keyframe(frame)
        pipe.count += 1
    pipe.flush()
    sync(pipe.device)


def _io_inclusive(pipe, frames, wl: dict, on_card: bool) -> float:
    """Frames/s of the headline pipeline fed from disk: the frames written
    once in the CA-1M layout (cached under the temp directory behind a
    completion marker), then each timed run reads them back through
    ``CA1MDataset`` (native decode, or PIL where the native loader does not
    build) and ``Prefetcher``, whose queue pre-fill is inside the window."""
    from boxfusion_tpu_torch.data.readers import CA1MDataset, write_ca1m_sequence
    from boxfusion_tpu_torch.native import Prefetcher

    S, gap, n_frames = wl["S"], wl["gap"], wl["n_frames"]
    io_dir = os.path.join(tempfile.gettempdir(), f"bfio_seq_torch_{S}_{n_frames}")
    # an interrupted earlier write, or another workload's, is rewritten
    marker = os.path.join(io_dir, ".complete.json")
    want = {"S": S, "n_frames": n_frames, "layout": 1}
    try:
        with open(marker) as fh:
            have = json.load(fh)
    except (OSError, ValueError):
        have = None
    if have != want:
        _log("headline: writing the CA-1M layout sequence to disk")
        write_ca1m_sequence(frames, io_dir)
        with open(marker, "w") as fh:
            json.dump(want, fh)
    cfg_io = _bench_cfg(on_card, wl)
    cfg_io["data"]._data["datadir"] = io_dir
    cfg_io["data"]._data["start"] = 0
    # the reader's size is (w, h): the frames are landscape
    cfg_io["cam"]._data["H"] = S
    cfg_io["cam"]._data["W"] = int(0.75 * S)
    cfg_io["cam"]._data["png_depth_scale"] = 1000.0
    pipe.reset()
    _warm(pipe, [fr for i, fr in zip(range(gap + 1), CA1MDataset(cfg_io))], gap)
    rates = []
    for _ in range(min(wl["n_runs"], 2)):
        pipe.reset()
        t0 = time.perf_counter()
        pipe.run(Prefetcher(CA1MDataset(cfg_io), depth=8), gap=gap, export=False)
        sync(pipe.device)
        rates.append(pipe.count / (time.perf_counter() - t0))
    return float(np.median(rates))


def _world_summary(world: dict) -> tuple:
    return int(world["scores"].shape[0]), {k: int(v) for k, v in world["stats"].items()}


def phase_headline(out_path: str, budget_s: float, device=None, wl=None) -> None:
    """The record's figure, then the secondary figures while the phase's
    budget allows: one the budget leaves out is named under
    ``skipped_figures``."""
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector
    from boxfusion_tpu_torch.runtime.device_state import export_world
    from boxfusion_tpu_torch.runtime.fused import FusedDevicePipeline

    t_phase = time.monotonic()
    dev, on_card = _phase_init(device)
    wl = wl or _workload(on_card)
    S, gap, n_frames, n_runs = wl["S"], wl["gap"], wl["n_frames"], wl["n_runs"]
    result = {"skipped_figures": []}

    _log("headline: building CuTR + CLIP")
    model, _ = _build_model(dev, wl)
    labeler = _make_labeler(on_card, dev)
    _seq, frames = _frames(wl)

    # headline profile: sized so NOTHING saturates at this detection rate
    # (~40-100 raw rows a keyframe x 21 keyframes): every surviving detection
    # gets a world slot, a CLIP label and an observation-bank entry
    cfg = _headline_cfg(on_card, wl)
    capacity = HEADLINE_CAPACITY if on_card else 256
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = FusedDevicePipeline(cfg, CuTRDetector(model, device=dev), labeler=labeler, capacity=capacity,
                               device=dev)
    _log("headline: warm-up (the kernels build here if they are not built)")
    _warm(pipe, frames[: 2 * gap + 1], gap)
    _log("headline: timing")

    runs, worlds = [], []
    for _ in range(n_runs):
        runs.append(_timed_run(pipe, frames, gap))
        # each run's world, read after its window
        worlds.append(_world_summary(export_world(pipe.state)))
    real_fps = float(np.median(runs))
    result.update(
        {
            "metric": (
                f"online e2e FPS, real path: CuTR-{wl['dim']} {wl['dtype_tag']} detect + CLIP label + "
                f"device-resident assoc+fusion @ {S}px, gap {gap}, one upload a keyframe (synthetic "
                "stream, random weights, class bias calibrated to a heavy detection load); "
                f"non-saturating profile: {capacity}-slot world, "
                f"{int(cfg['detection']['max_label_boxes'])}-crop label budget; each timed window "
                "ends in a synchronise"
            ),
            "value": round(real_fps, 3),
            "unit": "frames/s",
            # ESTIMATE: the paper-level ~10 FPS CUDA e2e claim, which includes
            # the dataset I/O this headline excludes (io_inclusive pays it)
            "vs_baseline": round(real_fps / 10.0, 3),
            "headline_runs_fps": [round(r, 3) for r in runs],
            "world_boxes_by_run": [n for n, _ in worlds],
            "world_stats_by_run": [st for _, st in worlds],
        }
    )
    if on_card:
        result["peak_memory_gib"] = round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
    _write_json(out_path, result)
    _log(f"headline: {real_fps:.1f} FPS (runs {[round(x, 1) for x in runs]})")

    # gap=1: a keyframe EVERY frame (cubicle.yaml's live-SLAM profile)
    kf1_frames = frames[: n_frames // 4]
    _warm(pipe, kf1_frames[:3], 1)
    n_sec = min(n_runs, 2)
    result["keyframes_per_s_gap1"] = round(float(np.median([_timed_run(pipe, kf1_frames, 1)
                                                             for _ in range(n_sec)])), 3)
    _write_json(out_path, result)
    _log(f"headline: gap=1 {result['keyframes_per_s_gap1']:.1f} keyframes/s")

    # I/O-inclusive: the reference's printed FPS includes decoding a png/jpg
    # pair from disk for every frame; noise images are PNG's decode worst
    # case, so this bounds real-scene I/O-inclusive FPS from below
    phase_left = budget_s - (time.monotonic() - t_phase)
    if phase_left > 180:
        result["io_inclusive_fps_ca1m_layout"] = round(_io_inclusive(pipe, frames, wl, on_card), 3)
        _write_json(out_path, result)
        _log(f"headline: io-inclusive {result['io_inclusive_fps_ca1m_layout']:.1f} FPS")
    else:
        result["skipped_figures"].append("io_inclusive_fps_ca1m_layout")
        _log(f"headline: io-inclusive skipped ({phase_left:.0f}s phase budget left)")

    # chunk=8: 8 keyframes a group, one upload, identical decisions
    # (tests/test_torch_fused.py), 8 keyframes of result latency.  The
    # headline `value` stays the per-keyframe (chunk=1) figure.
    phase_left = budget_s - (time.monotonic() - t_phase)
    if phase_left > 120:
        chunk_pipe = FusedDevicePipeline(cfg, CuTRDetector(model, device=dev), labeler=labeler,
                                         capacity=capacity, device=dev, chunk=8)
        _warm(chunk_pipe, kf1_frames[:9], 1)
        kf1c = [_timed_run(chunk_pipe, kf1_frames, 1) for _ in range(n_sec)]
        fpsc = [_timed_run(chunk_pipe, frames, gap) for _ in range(n_sec)]
        result["keyframes_per_s_gap1_chunk8"] = round(float(np.median(kf1c)), 3)
        result["fps_chunk8"] = round(float(np.median(fpsc)), 3)
        _write_json(out_path, result)
        _log(f"headline: chunk=8 gap=1 {result['keyframes_per_s_gap1_chunk8']:.1f} keyframes/s, "
             f"gap={gap} {result['fps_chunk8']:.1f} FPS")
    else:
        result["skipped_figures"] += ["keyframes_per_s_gap1_chunk8", "fps_chunk8"]
        _log(f"headline: chunk=8 skipped ({phase_left:.0f}s left)")

    # the LAST headline run's world: the saturation figures describe the
    # workload the headline FPS was measured on, not the side profiles
    n_world, world_stats = worlds[-1]
    result.update(
        {
            "world_boxes_final_run": n_world,
            "world_stats_final_run": world_stats,
            "headline_saturated": bool(world_stats.get("dropped_world_capacity", 0)
                                       or world_stats.get("label_overflow", 0)),
        }
    )
    _write_json(out_path, result)
    _log("headline: done (stats exported)")


# ---------------------------------------------------------------------------
# phase: stages (per-stage keyframe cost decomposition -> stage_ms)
# ---------------------------------------------------------------------------

def _timed_chain(fn, x0, reps: int, device: torch.device) -> float:
    """Mean ms of ``x = fn(x)`` over ``reps`` chained calls after a warm one."""
    x = fn(x0)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = fn(x)
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def phase_stages(out_path: str, budget_s: float, device=None, wl=None) -> None:
    """Per-stage costs of the real keyframe path: the CLIP tower at each
    label bucket, crop + resize, and the association / fusion step (oracle
    load, headline capacity) with fusion on and off.  Each figure is a
    dependency chain closed by a synchronise inside its window."""
    from boxfusion_tpu_torch.data.synthetic import OracleDetector
    from boxfusion_tpu_torch.models.clip.head import batched_crop_resize
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline
    from boxfusion_tpu_torch.runtime.fused import label_buckets_for

    dev, on_card = _phase_init(device)
    wl = wl or _workload(on_card)
    result = {"stage_ms": {}}
    stage = result["stage_ms"]

    _log("stages: CLIP tower per bucket")
    labeler = _make_labeler(on_card, dev)
    rng = np.random.RandomState(0)
    S = wl["S"]
    image = torch.as_tensor((rng.rand(int(0.75 * S), S, 3) * 255).astype(np.float32), device=dev)
    buckets = [b for b in label_buckets_for(128 if on_card else 32) if b > 0]
    reps = 6 if on_card else 2
    feat_dim = labeler.text_features.shape[1]
    with torch.inference_mode():
        for b in buckets:
            crops0 = torch.as_tensor(rng.rand(b, 224, 224, 3).astype(np.float32), device=dev)

            def step_tower(x, _crops0=crops0):
                feats = labeler.tower(_crops0 + x.mean() * 1e-12)
                return feats.float().sum(dim=0)

            stage[f"clip_tower_{b}"] = round(_timed_chain(step_tower, torch.zeros(feat_dim, device=dev), reps,
                                                          dev), 3)
            _write_json(out_path, result)
            _log(f"stages: clip_tower_{b} = {stage[f'clip_tower_{b}']} ms")

        boxes = torch.as_tensor((rng.rand(128, 4) * 150 + 5).astype(np.float32), device=dev)
        boxes[:, 2:] += boxes[:, :2]

        def step_crop(x):
            return batched_crop_resize(image + x.mean() * 1e-12, boxes).sum(dim=(0, 1, 2))

        stage["crop_resize_128"] = round(_timed_chain(step_crop, torch.zeros(3, device=dev), reps, dev), 3)
        _write_json(out_path, result)

    _log("stages: keyframe step (assoc+fusion) on the oracle load")
    seq, frames = _frames(wl)
    capacity = HEADLINE_CAPACITY if on_card else 256
    kf = frames[:: wl["gap"]][: 21 if on_card else 6]
    for tag, fuse_on in (("assoc_plus_fusion", True), ("assoc_only", False)):
        cfg = _bench_cfg(on_card, wl)
        cfg["box_fusion"]._data["use"] = fuse_on
        if on_card:
            cfg["association"]._data["max_observations"] = 16384
        pipe = DevicePipeline(cfg, OracleDetector(seq, noise=0.03, seed=1), capacity=capacity, device=dev)
        for fr in kf[:2]:
            pipe.process_keyframe(fr)
        pipe.flush()
        sync(dev)
        best = None
        for _ in range(2):
            pipe.reset()
            pipe.detector = OracleDetector(seq, noise=0.03, seed=1)
            t0 = time.perf_counter()
            for fr in kf:
                pipe.process_keyframe(fr)
            pipe.flush()
            sync(dev)
            dt = (time.perf_counter() - t0) / len(kf) * 1e3
            best = dt if best is None else min(best, dt)
        stage[f"step_{tag}"] = round(best, 3)
        _write_json(out_path, result)
        _log(f"stages: step_{tag} = {stage[f'step_{tag}']} ms/keyframe")
    stage["fusion_delta"] = round(max(stage["step_assoc_plus_fusion"] - stage["step_assoc_only"], 0.0), 3)
    _write_json(out_path, result)
    _log("stages: done")


# ---------------------------------------------------------------------------
# phase: stress (oracle-detection association/fusion load)
# ---------------------------------------------------------------------------

class BenchDetector:
    """Enqueues the real CuTR forward (its device time lands in the timed
    stream) and returns oracle detections, so association and fusion see a
    deterministic, high-occupancy box load."""

    def __init__(self, model, batch, seq):
        from boxfusion_tpu_torch.data.synthetic import OracleDetector

        self.model, self.batch = model, batch
        self.oracle = OracleDetector(seq, noise=0.03, seed=1)

    def __call__(self, frame):
        self.model(self.batch)
        return self.oracle(frame)


def phase_stress(out_path: str, budget_s: float, device=None, wl=None) -> None:
    from boxfusion_tpu_torch.runtime.device_pipeline import DevicePipeline

    dev, on_card = _phase_init(device)
    wl = wl or _workload(on_card)
    gap = wl["gap"]
    result = {}

    _log("stress: building CuTR")
    model, batch = _build_model(dev, wl)
    seq, frames = _frames(wl)
    pipe = DevicePipeline(_bench_cfg(on_card, wl), BenchDetector(model, batch, seq), capacity=256, device=dev)
    _warm(pipe, frames[: 2 * gap + 1], gap)
    _log("stress: warm; timing")
    runs = []
    for _ in range(wl["n_runs"]):
        # a fresh oracle per run: its RNG is consumed per call, and every run
        # must measure the same detection load
        pipe.detector = BenchDetector(model, batch, seq)
        runs.append(_timed_run(pipe, frames, gap))
    result["stress_fps_oracle_load"] = round(float(np.median(runs)), 3)
    _write_json(out_path, result)
    _log(f"stress: done ({result['stress_fps_oracle_load']:.1f} FPS)")


# ---------------------------------------------------------------------------
# phase: multistream (4 lanes in lockstep on one card)
# ---------------------------------------------------------------------------

def phase_multistream(out_path: str, budget_s: float, device=None, wl=None) -> None:
    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.runtime.batched import BatchedPipeline
    from boxfusion_tpu_torch.runtime.detector import CuTRDetector

    dev, on_card = _phase_init(device)
    wl = wl or _workload(on_card)
    S, gap = wl["S"], wl["gap"]
    result = {}

    _log("multistream: building CuTR + CLIP")
    model, _ = _build_model(dev, wl)
    labeler = _make_labeler(on_card, dev)
    lane_seqs = [list(SyntheticSequence(n_frames=wl["n_frames"] // 2, n_boxes=8, image_hw=(int(0.75 * S), S),
                                        seed=10 + s))
                 for s in range(4)]
    bp = BatchedPipeline(_bench_cfg(on_card, wl), CuTRDetector(model, device=dev), n_lanes=4, capacity=256,
                         transport="packed", labeler=labeler, device=dev)
    _log("multistream: warm-up run")
    bp.run(lane_seqs, gap=gap, export=False)
    sync(dev)
    n_frames_total = sum(len(s) for s in lane_seqs)
    runs = []
    for _ in range(wl["n_runs"]):
        bp.reset()
        t0 = time.perf_counter()
        bp.run(lane_seqs, gap=gap, export=False)
        sync(dev)
        runs.append(n_frames_total / (time.perf_counter() - t0))
    result["multistream_fps_4lanes_packed"] = round(float(np.median(runs)), 3)
    _write_json(out_path, result)
    _log(f"multistream: done ({result['multistream_fps_4lanes_packed']:.1f} FPS aggregate)")


PHASES = {
    "micro": phase_micro,
    "headline": phase_headline,
    "stages": phase_stages,
    "stress": phase_stress,
    "multistream": phase_multistream,
}
# (phase, the least time left to start it, its timeout given the time left),
# in the JAX bench's order: multistream before stages and stress
_SCHEDULE = (
    ("micro", 0.0, lambda left: min(600.0, max(120.0, left - 600))),
    ("headline", 240.0, lambda left: min(1100.0, left - 60)),
    ("multistream", 300.0, lambda left: min(420.0, left - 120)),
    ("stages", 240.0, lambda left: min(360.0, left - 90)),
    ("stress", 200.0, lambda left: min(300.0, left - 60)),
)
PHASE_ORDER = tuple(name for name, _, _ in _SCHEDULE)


# ---------------------------------------------------------------------------
# parent orchestration (no device work of its own)
# ---------------------------------------------------------------------------

def card() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    name, power_limit = (s.strip() for s in out.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit": power_limit}


def _phase_argv(name: str, out_path: str, timeout_s: float, device: str) -> list:
    return [sys.executable, "-m", "boxfusion_tpu_torch.bench", "--phase", name, "--out", out_path,
            "--budget", str(timeout_s), "--device", device]


def _run_phase(name: str, timeout_s: float, device: str) -> tuple:
    """Run one phase in its own subprocess; returns (the figures it wrote,
    None or why it failed).  Its stdout goes to this process's stderr, so
    the parent's stdout carries the record lines alone."""
    os.makedirs(RESULTS, exist_ok=True)
    out_path = os.path.join(RESULTS, f"phase_{name}.json")
    try:
        os.remove(out_path)
    except FileNotFoundError:
        pass
    _log(f"phase {name}: starting (timeout {timeout_s:.0f}s)")
    failure = None
    try:
        proc = subprocess.run(_phase_argv(name, out_path, timeout_s, device), timeout=timeout_s, cwd=REPO,
                              stdout=2)  # this process's stderr
        if proc.returncode != 0:
            failure = f"exited rc={proc.returncode}"
    except subprocess.TimeoutExpired:
        failure = f"timed out after {timeout_s:.0f}s"
    if failure:
        _log(f"phase {name}: FAILED ({failure}); keeping its partial figures")
    try:
        with open(out_path) as f:
            return json.load(f), failure
    except (OSError, ValueError):
        return {}, failure


def _emit(result: dict) -> None:
    """Print the figures so far as ONE JSON line and mirror it to
    ``results/bench_torch/partial.json``; each line supersedes the last."""
    line = json.dumps(result)
    print(line, flush=True)
    with open(os.path.join(RESULTS, "partial.json"), "w") as f:
        f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--phase", choices=sorted(PHASES), default=None, help="run one phase in this process")
    ap.add_argument("--out", default=None, help="the phase's result file")
    ap.add_argument("--budget", type=float, default=600.0, help="the phase's seconds")
    args = ap.parse_args(argv)
    if args.phase:
        PHASES[args.phase](args.out, args.budget, args.device)
        return 0

    t0 = time.monotonic()
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "1500"))
    dev = resolve_device(args.device)  # no card and no --device cpu: refuse
    os.makedirs(RESULTS, exist_ok=True)
    result = {"device": dev.type, "card": card() if dev.type == "cuda" else None}
    if dev.type != "cuda":
        result["note"] = "CPU run: the kernels ran as their plain PyTorch versions; no figure is a device figure"
    failed, skipped = [], []
    for name, least, timeout in _SCHEDULE:
        left = deadline - (time.monotonic() - t0)
        if left <= least:
            _log(f"{name}: skipped (deadline)")
            skipped.append(name)
            continue
        figures, failure = _run_phase(name, timeout(left), str(dev))
        figures.pop("on_card", None)
        result.update(figures)
        if failure:
            failed.append(name)
        result.update(failed_phases=failed, skipped_phases=skipped)
        _emit(result)
    result["bench_wall_s"] = round(time.monotonic() - t0, 1)
    _emit(result)
    _log("bench complete" + (f"; FAILED phases: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
