"""Spans and records around calls into the program's layers, from outside.

Each probe replaces one name for the length of a ``with`` block and puts it
back afterwards.  Where a later version of the program no longer has the
name, the probe records nothing and the metrics that read it are left out
of the result; the run goes on.
"""
from __future__ import annotations

import importlib
from typing import Callable, List

import torch

SPANS = ("bench.detect", "bench.label", "bench.step")


class _Patch:
    def __init__(self, module: str, name: str, make: Callable):
        self.module, self.name, self.make = module, name, make
        self.active = False

    def __enter__(self):
        try:
            self.mod = importlib.import_module(self.module)
            self.saved = getattr(self.mod, self.name)
        except (ImportError, AttributeError):
            return self
        setattr(self.mod, self.name, self.make(self.saved))
        self.active = True
        return self

    def __exit__(self, *exc):
        if self.active:
            setattr(self.mod, self.name, self.saved)
        return False


def _spanned(span: str):
    def make(fn):
        def call(*args, **kw):
            with torch.profiler.record_function(span):
                return fn(*args, **kw)
        return call
    return make


class Probes:
    """The spans of detect (the model's forward), label
    (``runtime.fused.label_boost_core``) and step (``runtime.fused._step``);
    each PST search's inputs (``ops.pst_search.pst_search`` as
    ``fusion.optimizer`` calls it); each attention kernel call's shape, at
    ``attention_sites``: the ``module.attribute`` names through which the
    labeler's tower calls ``whole_seq_attention`` (its family's
    ``ATTENTION_SITES``)."""

    def __init__(self, model, attention_sites):
        self.model = model
        self.attention_sites = tuple(attention_sites)
        self.searches: List[tuple] = []
        self.attention: List[tuple] = []
        self.found = {}

    def __enter__(self):
        def searched(fn):
            def call(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep, H, W, cfg):
                out = fn(init_xyzlhw, R, pst, cam_poses, K, view_mask, obj_mask, prep, H, W, cfg)
                N, V = view_mask.shape
                self.searches.append((out[2], view_mask, int(pst.shape[0]), prep["pvalid"].reshape(N, V, -1)))
                return out
            return call

        def attended(fn):
            def call(q, k, v, heads, sm_scale):
                B, T, D = (int(x) for x in q.shape)
                self.attention.append((B, T, int(heads), D // int(heads), q.element_size()))
                return fn(q, k, v, heads=heads, sm_scale=sm_scale)
            return call

        self.patches = [
            _Patch("boxfusion_tpu_torch.runtime.fused", "label_boost_core", _spanned("bench.label")),
            _Patch("boxfusion_tpu_torch.runtime.fused", "_step", _spanned("bench.step")),
            _Patch("boxfusion_tpu_torch.fusion.optimizer", "pst_search", searched),
        ] + [_Patch(*site.rsplit(".", 1), attended) for site in self.attention_sites]
        for p in self.patches:
            p.__enter__()
            self.found[f"{p.module}.{p.name}"] = p.active
        forward = self.model.forward
        self.model.forward = _spanned("bench.detect")(forward)
        return self

    def __exit__(self, *exc):
        del self.model.forward
        for p in reversed(self.patches):
            p.__exit__()
        return False
