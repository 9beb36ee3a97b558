"""The measured window: a closed loop of scans through the fused engine.

Each scan: ``reset()``, every keyframe through ``process_keyframe`` (the
frames between keyframes are counted, as ``DevicePipeline.run`` counts
them), then ``flush()`` and ``export_world``: users read the map at the end
of a scan.  The next keyframe is handed over as soon as the engine returns
from the last one.  The window ends on the first keyframe boundary after
``seconds``, followed by a synchronise.

A keyframe's latency runs from its hand-off to the moment the card has
finished its work.  On a card a timing event is recorded after each
``process_keyframe`` (no synchronise in the loop); after the window each
event's time is placed on the host clock through an anchor event recorded on
the idle stream when the window opened.

The recorder keeps, by reference and without copies, what the engine
produced for the correctness check: every keyframe's CuTR rows and label
outputs, and at the positions drawn from the seed the engine's state before
and after the keyframe (the step never writes into a state it was given, so
holding the old one costs no copy).

Those records stay on the card until the window ends, so the allocator's
peak over the window grows with the keyframes the window holds.  With
``measure_memory`` the window is cut into segments (the ``reset()`` that
opens a scan, each ``process_keyframe``, the ``flush`` and export that close
it) and the allocator's peak is read and reset at each boundary, from the
host and with no synchronise.  A segment's peak less the card bytes that
only the harness held all through it (records of earlier segments, not
shared with the engine's live state) is what the program needed; the window's net peak is the largest of these.  Memory the
program itself keeps from keyframe to keyframe still counts in full.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

_DET_KEYS = ("scores", "pred_boxes", "boxes3d", "R", "proj_xy", "enc_logits")
# the caching allocator hands out blocks in multiples of this many bytes
ALLOC_ROUND = 512


@dataclasses.dataclass
class KeyframeRecord:
    scan: int                 # ordinal of the scan in the window
    index: int                # the keyframe's stream index in its scan
    count: int                # the engine's frame counter at the keyframe
    det: Optional[dict] = None
    label: Optional[dict] = None
    state_before: object = None
    state_after: object = None


@dataclasses.dataclass
class WindowResult:
    frames: int
    keyframes: int
    seconds: float
    latencies_ms: List[float]
    scans_completed: int
    records: List[KeyframeRecord]
    exports: Dict[int, dict]  # scan ordinal -> its exported world
    searches: List[dict]      # each PST search's inputs and results
    # with ``measure_memory`` (peaks 0 off a card): the allocator's peak over
    # the window, the largest segment peak net of the bytes only the harness
    # held, the most such bytes, and the host seconds the accounting took
    peak_bytes: int = 0
    peak_net_bytes: int = 0
    harness_bytes: int = 0
    accounting_s: float = 0.0


class Recorder:
    """Wraps the engine's model forward and label call (instance attributes,
    the program's objects untouched otherwise) and the step's call of the
    PST search (``runtime.device_step.optimize_boxes``; where a later
    version has no such name, searches are judged only inside the sampled
    keyframes) to keep their inputs and outputs."""

    def __init__(self, program):
        self.program = program
        self.current: Optional[KeyframeRecord] = None
        self.searches: List[dict] = []

    def __enter__(self):
        from benchmark.harness.probes import _Patch

        def recorded_search(fn):
            def call(init_xyzlhw, init_R, pst, cam_poses, obs_corners, view_mask, obj_mask, K, H, W,
                     cfg, device=None):
                fused, updated = fn(init_xyzlhw, init_R, pst, cam_poses, obs_corners, view_mask, obj_mask,
                                    K, H, W, cfg, device=device)
                self.searches.append(dict(init_x=init_xyzlhw, init_R=init_R, poses=cam_poses,
                                          corners=obs_corners, vmask=view_mask, active=obj_mask, K=K,
                                          H=H, W=W, fused=fused, updated=updated))
                return fused, updated
            return call

        self.search_patch = _Patch("boxfusion_tpu_torch.runtime.device_step", "optimize_boxes", recorded_search)
        self.search_patch.__enter__()
        model, labeler = self.program.model, self.program.labeler
        forward, label = model.forward, labeler.label_boost_lanes

        def recorded_forward(*args, **kw):
            out = forward(*args, **kw)
            if self.current is not None:
                self.current.det = {k: (out[k] if k == "enc_logits" else out[k][0]) for k in _DET_KEYS}
            return out

        def recorded_label(images, boxes, scores, hws, scale, coeff, budget=32):
            out = label(images, boxes, scores, hws, scale, coeff, budget=budget)
            if self.current is not None:
                new_scores, categories, _, overflow = out
                self.current.label = dict(b=min(int(budget), int(scores.shape[-1])),
                                          new_scores=new_scores[0], categories=categories[0],
                                          overflow=overflow[0])
            return out

        model.forward, labeler.label_boost_lanes = recorded_forward, recorded_label
        return self

    def __exit__(self, *exc):
        del self.program.model.forward  # back to the class's methods
        del self.program.labeler.label_boost_lanes
        self.search_patch.__exit__()


def storages(obj, device_type: str) -> Dict[int, int]:
    """``data_ptr`` -> bytes of each storage on a ``device_type`` device that
    the tensors reachable from ``obj`` through dicts, lists, tuples and
    dataclass fields hold, rounded up as the caching allocator rounds a
    block."""
    out = {}
    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.device.type == device_type:
                s = o.untyped_storage()
                out[s.data_ptr()] = -(-s.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            stack.extend(getattr(o, f.name) for f in dataclasses.fields(o))
    return out


class Segments:
    """The allocator's peak, segment by segment, net of the card bytes that
    only the harness held all through a segment (see the module's
    docstring).  ``kept`` grows by each finished segment's records; of it,
    the storages that the engine's live state held at the segment's start
    or holds at its end are left out."""

    def __init__(self, pipe, device: torch.device):
        self.pipe, self.device, self.cuda = pipe, device, device.type == "cuda"
        self.kept: Dict[int, int] = {}
        self.kept_total = 0
        self.peak = self.net = self.harness = 0
        self.seconds = 0.0

    def open(self) -> None:
        t0 = time.perf_counter()
        self.live_before = self._live()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.seconds += time.perf_counter() - t0

    def close(self, new=()) -> None:
        """End a segment; ``new`` is what the harness kept from it."""
        t0 = time.perf_counter()
        live = self._live()
        shared = live.keys() | self.live_before.keys()
        held = self.kept_total - sum(self.kept.get(p, 0) for p in shared)
        self.harness = max(self.harness, held)
        if self.cuda:
            # ``max_memory_allocated``'s value, without flattening every other statistic
            peak = int(torch.cuda.memory_stats_as_nested_dict(self.device)["allocated_bytes"]["all"]["peak"])
            torch.cuda.reset_peak_memory_stats(self.device)
            self.peak, self.net = max(self.peak, peak), max(self.net, peak - held)
        for p, n in storages(new, self.device.type).items():
            if p not in self.kept:
                self.kept[p] = n
                self.kept_total += n
        self.live_before = live
        self.seconds += time.perf_counter() - t0

    def _live(self) -> Dict[int, int]:
        """Storages the engine holds between keyframes: its world state's and
        its other tensors'."""
        pipe = self.pipe
        return storages([pipe.state] + [v for v in vars(pipe).values() if isinstance(v, torch.Tensor)],
                        self.device.type)


class _Clock:
    """Completion times of keyframes on the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def open(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
        self.t_anchor = time.perf_counter()
        return self.t_anchor

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def close(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def completions(self) -> List[float]:
        if not self.cuda:
            return list(self.marks)
        return [self.t_anchor + self.anchor.elapsed_time(ev) / 1e3 for ev in self.marks]


def run_window(program, scans, seconds: float, device: torch.device,
               capture: Set[Tuple[int, int]] = frozenset(), keep_records: bool = True,
               max_keyframes: Optional[int] = None, measure_memory: bool = False) -> WindowResult:
    """Stream the cycle of ``scans`` for ``seconds`` (or ``max_keyframes``).

    ``capture``: (scan ordinal, keyframe index) positions whose states
    before and after are kept.  Scan 0's export is kept too.
    ``measure_memory``: read the allocator's peak segment by segment (it
    resets the peak, so a caller whose own peak spans this window, as
    set-up's does, leaves it off)."""
    from boxfusion_tpu_torch.runtime.device_state import export_world

    pipe = program.pipe
    clock = _Clock(device)
    records: List[KeyframeRecord] = []
    exports: Dict[int, dict] = {}
    handoffs: List[float] = []
    frames = keyframes = completed = searches_seen = 0
    recorder = Recorder(program) if keep_records else None
    segments = Segments(pipe, device) if measure_memory else None
    done = False
    with (recorder or _Null()):
        t0 = clock.open()
        if segments is not None:
            segments.open()
        ordinal = 0
        while not done:
            scan = scans[ordinal % len(scans)]
            pipe.reset()
            if segments is not None:
                segments.close()
            for i in range(scan.n_frames):
                frame = scan.frames.get(i)
                if frame is not None:
                    rec = KeyframeRecord(scan=ordinal, index=i, count=pipe.count)
                    keep_state = (ordinal, i) in capture
                    if keep_state:
                        rec.state_before = pipe.state
                    if recorder is not None:
                        recorder.current = rec
                    handoffs.append(time.perf_counter())
                    pipe.process_keyframe(frame)
                    clock.mark()
                    if keep_state:
                        rec.state_after = pipe.state
                    if recorder is not None:
                        records.append(rec)
                        recorder.current = None
                    if segments is not None:
                        new = []
                        if recorder is not None:
                            new, searches_seen = [rec, recorder.searches[searches_seen:]], len(recorder.searches)
                        segments.close(new)
                    keyframes += 1
                pipe.count += 1
                frames += 1
                if frame is not None and (time.perf_counter() - t0 >= seconds
                                          or (max_keyframes is not None and keyframes >= max_keyframes)):
                    done = True
                    break
            else:
                pipe.flush()
                world = export_world(pipe.state)
                if ordinal == 0 and keep_records:
                    exports[0] = world
                completed += 1
                if segments is not None:
                    segments.close()
            ordinal += 1
        pipe.flush()
        if segments is not None:
            segments.close()
        t1 = clock.close()
    latencies = [(c - h) * 1e3 for c, h in zip(clock.completions(), handoffs)]
    result = WindowResult(frames=frames, keyframes=keyframes, seconds=t1 - t0, latencies_ms=latencies,
                          scans_completed=completed, records=records, exports=exports,
                          searches=recorder.searches if recorder is not None else [])
    if segments is not None:
        result.peak_bytes, result.peak_net_bytes = segments.peak, segments.net
        result.harness_bytes, result.accounting_s = segments.harness, segments.seconds
    return result


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))
