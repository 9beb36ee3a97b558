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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

_DET_KEYS = ("scores", "pred_boxes", "boxes3d", "R", "proj_xy", "enc_logits")


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
               max_keyframes: Optional[int] = None) -> WindowResult:
    """Stream the cycle of ``scans`` for ``seconds`` (or ``max_keyframes``).

    ``capture``: (scan ordinal, keyframe index) positions whose states
    before and after are kept.  Scan 0's export is kept too."""
    from boxfusion_tpu_torch.runtime.device_state import export_world

    pipe = program.pipe
    clock = _Clock(device)
    records: List[KeyframeRecord] = []
    exports: Dict[int, dict] = {}
    handoffs: List[float] = []
    frames = keyframes = completed = 0
    recorder = Recorder(program) if keep_records else None
    done = False
    with (recorder or _Null()):
        t0 = clock.open()
        ordinal = 0
        while not done:
            scan = scans[ordinal % len(scans)]
            pipe.reset()
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
            ordinal += 1
        pipe.flush()
        t1 = clock.close()
    latencies = [(c - h) * 1e3 for c, h in zip(clock.completions(), handoffs)]
    return WindowResult(frames=frames, keyframes=keyframes, seconds=t1 - t0, latencies_ms=latencies,
                        scans_completed=completed, records=records, exports=exports,
                        searches=recorder.searches if recorder is not None else [])


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))
