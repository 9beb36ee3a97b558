"""Black-box CLI parity with the original BoxFusion: the port's own harness.

Port of what ``tests/blackbox_harness.py`` gives the reference-parity tools
(``run_blackbox_parity``, ``diagnose_parity_band``, ``profile_host_engine``)
and ``build_parity_fixture``: the original ``demo.py`` (at ``REF``) is run
in-process on the CPU with its unavailable third-party imports stubbed, on a
synthetic CA-1M-layout folder, and its eval pickles are compared with the
port's CLI run on the same folder with the same checkpoint.

Stubs (none touches the compute path): cv2 -> PIL / numpy; pycuda -> an
importable no-op whose kernels raise if launched (``box_fusion.use`` must be
False); rerun / open3d -> attribute sinks; open_clip -> an empty module;
SAMCLIP -> a deterministic image-feature stand-in (the reference imports
``model.samclip_predictor``, which it does not ship); timm / torchvision ->
the pieces the reference's CuTR and data path import; ``Tensor.cuda`` -> the
identity while ``demo.py`` runs.  ``write_config`` makes labeling
decision-neutral (``class_sim_thres`` -1e9, ``clip_sim_coeff`` 0).

``REF`` is read at every call, so a caller may point it elsewhere
(``blackbox.REF = path``).  Without ``REF/demo.py`` nothing here can run the
reference; ``reference_missing`` gives the line a tool prints then.
"""
from __future__ import annotations

import contextlib
import importlib.machinery
import io
import os
import re
import sys
import types
from typing import Optional, Sequence, Tuple

import numpy as np

REF = "/root/reference"
SEQ = "42898867"  # the parity scene's video id


def reference_available() -> bool:
    """True only when the original BoxFusion's ``demo.py`` is at ``REF``."""
    return os.path.isfile(os.path.join(REF, "demo.py"))


def reference_missing(tool: str) -> Optional[str]:
    """None when the reference is there, else the one line ``tool`` prints
    before it exits with status 2."""
    if reference_available():
        return None
    return (f"{tool}: the original BoxFusion is not at {REF} ({os.path.join(REF, 'demo.py')} is missing); "
            "nothing was run")


# --------------------------------------------------------------------- stubs
def _mod(name: str) -> types.ModuleType:
    m = types.ModuleType(name)
    # a real ModuleSpec: transformers' optional-dependency probe walks
    # sys.modules and raises on spec-less stubs
    m.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
    sys.modules[name] = m
    return m


class _AttrSink:
    """Constructible / callable attribute black hole for viz-only APIs."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, *a, **k):
        return _AttrSink()

    def __getattr__(self, name):
        return _AttrSink()


def _sink_module(name: str) -> types.ModuleType:
    m = _mod(name)
    m.__getattr__ = lambda attr: _AttrSink()
    return m


def _install_reference() -> None:
    """timm's Mlp and torchvision's transforms as the reference's CuTR and
    data path import them; ``REF`` on sys.path."""
    import torch.nn as nn

    class Mlp(nn.Module):
        def __init__(self, in_features, hidden_features, act_layer=nn.GELU, bias=True):
            super().__init__()
            self.fc1 = nn.Linear(in_features, hidden_features, bias=bias)
            self.act = act_layer()
            self.fc2 = nn.Linear(hidden_features, in_features, bias=bias)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    class _Noop:
        def __init__(self, *a, **k):
            pass

        def __call__(self, x):
            return x

    if "timm" not in sys.modules:
        timm, layers = _mod("timm"), _mod("timm.layers")
        layers.Mlp = Mlp
        timm.layers = layers
    if "torchvision" not in sys.modules:
        tv, tvt = _mod("torchvision"), _mod("torchvision.transforms")
        tvt.Compose = lambda fns: _Noop()
        tvt.Normalize = _Noop
        tv.transforms = tvt
    if REF not in sys.path:
        sys.path.insert(0, REF)


def _install_pycuda_stub() -> None:
    """An importable pycuda: the reference's box_fusion.py subclasses
    ``cuda.PointerHolderBase`` at import time (box_fusion.py:19)."""
    if "pycuda" in sys.modules:
        return
    pycuda, driver = _mod("pycuda"), _mod("pycuda.driver")

    class PointerHolderBase:
        pass

    driver.PointerHolderBase = PointerHolderBase
    pycuda.driver = driver
    pycuda.autoprimaryctx = _mod("pycuda.autoprimaryctx")
    pycuda.compiler = _mod("pycuda.compiler")
    pycuda.gpuarray = _mod("pycuda.gpuarray")


def _benign_source_module() -> None:
    """BoxFusion.__init__ always compiles its CUDA source (box_fusion.py:63-409);
    give it a handle whose kernel raises only if it is launched."""

    class SourceModule:
        def __init__(self, *a, **k):
            pass

        def get_function(self, name):
            def _never(*a, **k):
                raise RuntimeError("CUDA kernel launched inside the CPU black-box harness "
                                   "(box_fusion.use must be False)")

            return _never

    sys.modules["pycuda.compiler"].SourceModule = SourceModule


def _install_cv2() -> None:
    if "cv2" in sys.modules:
        return
    from PIL import Image

    cv2 = _mod("cv2")
    cv2.IMREAD_UNCHANGED = -1
    cv2.COLOR_BGR2RGB = 4
    cv2.INTER_LINEAR = 1

    def imread(path, flags=None):
        im = Image.open(path)
        if flags in (-1, cv2.IMREAD_UNCHANGED):
            return np.asarray(im)  # uint16 png / float32 tiff, unchanged
        return np.asarray(im.convert("RGB"))[..., ::-1].copy()  # 3-channel BGR like cv2

    def cvtColor(img, code):
        return img[..., ::-1].copy()

    def resize(img, dsize, interpolation=None):
        w, h = int(dsize[0]), int(dsize[1])
        if img.shape[1] == w and img.shape[0] == h:
            return img.copy()  # the parity scenes are written at the target size
        if img.ndim == 2:
            out = Image.fromarray(np.asarray(img, np.float32), mode="F").resize((w, h), Image.BILINEAR)
            return np.asarray(out, img.dtype if img.dtype != np.uint16 else np.float32)
        return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))

    cv2.imread, cv2.cvtColor, cv2.resize = imread, cvtColor, resize


def _install_viz_stubs() -> None:
    if "rerun" not in sys.modules:
        rr = _sink_module("rerun")
        rr.blueprint = _sink_module("rerun.blueprint")
    if "open3d" not in sys.modules:
        _sink_module("open3d")
    if "open_clip" not in sys.modules:
        _mod("open_clip")


def _install_samclip(feature_dim: int = 8) -> None:
    if "model.samclip_predictor" in sys.modules:
        return
    import torch

    pkg = _mod("model")

    class SAMCLIP:
        """Deterministic stand-in for the external image tower: features of
        coarse crop statistics, so every run sees the same labels (the parity
        config makes labels decision-neutral anyway)."""

        def __init__(self, *a, **k):
            pass

        def get_batch_images_clip_features(self, images):
            feats = []
            for im in images:
                a = np.asarray(im, np.float32)
                mean_rgb = a.mean(axis=(0, 1)) if a.ndim == 3 else np.zeros(3)
                v = np.array([a.mean(), a.std(), *mean_rgb[:3], a.max(), a.min(), 1.0], np.float32)[:feature_dim]
                feats.append(np.pad(v, (0, max(0, feature_dim - v.size)), constant_values=1.0))
            out = torch.tensor(np.stack(feats)) if feats else torch.zeros((0, feature_dim))
            return out, None

    sub = _mod("model.samclip_predictor")
    sub.SAMCLIP = SAMCLIP
    pkg.samclip_predictor = sub


def _extend_torchvision() -> None:
    """tools/utils.py:10 of the reference imports
    torchvision.transforms.functional.pil_to_tensor."""
    import torch

    if "torchvision.transforms.functional" in sys.modules:
        return
    tvf = _mod("torchvision.transforms.functional")

    def pil_to_tensor(pic):
        a = np.asarray(pic)
        a = a[None] if a.ndim == 2 else np.moveaxis(a, -1, 0)
        return torch.from_numpy(np.ascontiguousarray(a))

    tvf.pil_to_tensor = pil_to_tensor
    tv = sys.modules.get("torchvision.transforms")
    if tv is not None:
        tv.functional = tvf


def install_demo_stubs() -> None:
    """Install every stub demo.py needs; idempotent."""
    _install_reference()
    _install_pycuda_stub()
    _benign_source_module()
    _install_cv2()
    _install_viz_stubs()
    _install_samclip()
    _extend_torchvision()


@contextlib.contextmanager
def _cpu_cuda_tensors():
    """demo.py:461 does ``torch.load(...).cuda()``; make .cuda the identity."""
    import torch

    orig = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        yield
    finally:
        torch.Tensor.cuda = orig


# ------------------------------------------------------------- checkpoints
def build_reference_checkpoint(path: str, dimension: int = 192, seed: int = 0) -> str:
    """A seeded random CuTR in the reference's checkpoint format (demo.py:441:
    ``torch.load(p)["model"]``).  The port's CuTR already carries the
    original state-dict names, so no converter is needed."""
    import torch

    from boxfusion_tpu_torch.models.cutr import make_cutr

    sd = make_cutr(dimension, depth_model=True, device="cpu", seed=seed).state_dict()
    torch.save({"model": sd}, path)
    return path


def train_stages(seqdir: str, cfg_path: str, ckpt_dir: str, stages: Sequence[Tuple[int, Optional[float]]],
                 dim: int = 192, batch: int = 2, seed: int = 0, device=None, extra: Sequence[str] = (),
                 log=None) -> str:
    """The port's trainer (``--data-root`` mode, gap 1, depth ratio 1) over
    ``stages`` of (steps, learning rate; None: the trainer's default), each
    resuming from the last one's checkpoint; returns the final checkpoint."""
    import time

    from boxfusion_tpu_torch.train.__main__ import main as train_main

    resume = None
    for steps, lr in stages:
        t0 = time.perf_counter()
        argv = ["--steps", str(steps), "--batch", str(batch), "--dim", str(dim), "--seed", str(seed),
                "--data-root", seqdir, "--train-config", cfg_path, "--gap", "1", "--depth-ratio", "1",
                "--ckpt-dir", ckpt_dir, "--ckpt-every", str(10 ** 9), "--log-every", str(max(1, steps // 4)),
                *extra]
        if lr is not None:
            argv += ["--lr", str(lr)]
        if device is not None:
            argv += ["--device", str(device)]
        if resume:
            argv += ["--resume", resume]
        train_main(argv)
        resume = os.path.join(ckpt_dir, f"step_{steps:07d}")
        if log is not None:
            log(steps, lr, time.perf_counter() - t0)
    return resume


def export_checkpoint(ckpt: str, out: str) -> str:
    """A checkpoint of the port's trainer as a reference ``.pth``:
    ``{"model": state_dict}`` in float32."""
    import torch

    from boxfusion_tpu_torch.utils.checkpoint import restore_params

    sd = {k: v.detach().to(torch.float32).contiguous() for k, v in restore_params(ckpt).items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({"model": sd}, out)
    return out


def build_trained_checkpoint(path: str, seqdir: str, cfg_path: str, steps: int = 60, dim: int = 192,
                             batch: int = 4, n_boxes: int = 8, seed: int = 0, device=None) -> str:
    """CuTR trained briefly on the black-box scene, exported as a ``.pth``.

    With random weights every selection stage of the detector sits in a band
    of near-tie scores narrower than the noise between two correct stacks,
    so their worlds legitimately differ; an overfit on the scene's ground
    truth restores margins far above that noise and makes the comparison
    deterministic."""
    ckpt = train_stages(seqdir, cfg_path, os.path.join(os.path.dirname(os.path.abspath(path)), "train_ckpt"),
                        [(steps, None)], dim=dim, batch=batch, seed=seed, device=device,
                        extra=("--n-boxes", str(n_boxes)))
    return export_checkpoint(ckpt, path)


# ------------------------------------------------------------ scene, config
def write_scene(datadir: str, n_frames: int, image_hw=(192, 256), n_boxes: int = 6, seed: int = 0) -> int:
    """A synthetic posed RGB-D sequence in the CA-1M disk layout both CLIs
    read, plus its world-corner ground truth (``after_filter_boxes.npy``, the
    data_process filter-gt format), so the sequence also trains."""
    import torch

    from boxfusion_tpu_torch.data.readers import write_ca1m_sequence
    from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
    from boxfusion_tpu_torch.geometry.boxes import box_corners

    seq = SyntheticSequence(n_frames=n_frames, n_boxes=n_boxes, image_hw=image_hw, seed=seed)
    n = write_ca1m_sequence(seq, datadir)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    corners = box_corners(f32(seq.gt_xyzlhw), f32(seq.gt_R)).numpy()
    np.save(os.path.join(datadir, "after_filter_boxes.npy"), corners)
    return n


def write_class_assets(outdir: str, feature_dim: int = 8):
    """A small class list and a unit-normalised text-feature bank (.pt), in
    place of data/panoptic_categories_nomerge.txt and class_features.pt."""
    import torch

    classes = ["chair", "table", "sofa", "bed", "lamp", "shelf"]
    txt = os.path.join(outdir, "classes.txt")
    with open(txt, "w") as f:
        f.write("\n".join(classes) + "\n")
    g = torch.Generator().manual_seed(7)
    feats = torch.randn(len(classes), feature_dim, generator=g)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    pt = os.path.join(outdir, "class_features.pt")
    torch.save(feats, pt)
    return txt, pt


def write_config(path: str, datadir: str, output_dir: str, gap: int, image_hw=(192, 256),
                 score_thresh: float = 0.03, fusion: bool = False, check_valid: bool = False,
                 max_detections: int = 100) -> str:
    """One YAML for both stacks: the keys the port's schema validates and
    every key demo.py reads (class_sim_thres, size_max_thres, clip_sim_coeff
    included).  Labeling is decision-neutral: class_sim_thres -1e9 (the
    background column never wins) and clip_sim_coeff 0 (no score boost)."""
    import yaml

    h, w = image_hw
    cfg = {
        "dataset": "CA1M",
        "data": {"datadir": datadir, "start": 0, "output_dir": output_dir, "gap": int(gap)},
        # CA-1M's camera convention: W is the image height, H its width
        "cam": {"H": int(w), "W": int(h), "png_depth_scale": 1000.0},
        "detection": {
            "score_thresh": float(score_thresh), "uv_bound": False, "uv_bound_value": 0.9,
            "floor_mask": False, "floor_ratio": 15, "scale_box": 1.5, "class_sim_thres": -1.0e9,
            "size_max_thres": 0, "max_detections": int(max_detections), "compute_dtype": "float32",
        },
        "association": {"small_threshold": 0.2, "rotation_gap": 30, "translation_gap": 0.8},
        "box_fusion": {
            "use": bool(fusion), "iters": 20, "pst_path": os.path.join(REF, "data", "pst_1024_0.tiff"),
            "pst_size": 1024,
            "random_opt": {"center_init_size": 0.1, "center_scaling_coefficient": 0.1,
                           "shape_init_size": 0.5, "shape_scaling_coefficient": 0.5},
            "check_valid": bool(check_valid), "nms_threshold": 0.1, "small_size": 0.5,
            "clip_sim_coeff": 0.0,
        },
        "vis": {"rerun": False, "show_class": False, "show_label": False, "trajectory": False},
        "eval": True,
    }
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


# ------------------------------------------------------------------- runs
_FPS_RE = re.compile(r"Average FPS: ([0-9.]+)")


def run_reference_demo(cfg_path: str, seq: str, ckpt: str, class_txt: str, class_features: str) -> dict:
    """``REF/demo.py``'s ``__main__`` in-process on the CPU; returns
    {"fps", "stdout"}.  demo.py rewrites the datadir to the sibling
    ``<parent>/<seq>/`` of ``cfg.data.datadir`` (demo.py:424-425), so the
    config names ``<parent>/_base/``."""
    import runpy

    install_demo_stubs()
    argv = ["demo.py", "ca1m", "--model-path", ckpt, "--config", cfg_path, "--seq", seq,
            "--class_txt", class_txt, "--class_features", class_features, "--device", "cpu"]
    buf = io.StringIO()
    old_argv = sys.argv
    sys.argv = argv
    try:
        with _cpu_cuda_tensors(), contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REF, "demo.py"), run_name="__main__")
    finally:
        sys.argv = old_argv
    out = buf.getvalue()
    m = _FPS_RE.search(out)
    return {"fps": float(m.group(1)) if m else None, "stdout": out}


def run_our_cli(cfg_path: str, datadir: str, ckpt: str, engine: str = "host", extra=(), device=None) -> dict:
    """``boxfusion_tpu_torch.cli.main`` on the same folder; returns {"fps", "stdout"}."""
    from boxfusion_tpu_torch import cli

    buf = io.StringIO()
    argv = [datadir, "--config", cfg_path, "--model-path", ckpt, "--engine", engine, *extra]
    if device is not None:
        argv += ["--device", str(device)]
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli.main rc={rc}\n{out[-4000:]}")
    m = _FPS_RE.search(out)
    return {"fps": float(m.group(1)) if m else None, "stdout": out}


# ------------------------------------------------------------- comparison
def load_corner_pickle(path: str) -> np.ndarray:
    """The (N, 8, 3) corner stack of a save_box pickle (the reference's
    tools/utils.py:322-332 format: [[(class_idx, corners, score), ...]])."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f)
    entries = data[0]
    if not entries:
        return np.zeros((0, 8, 3), np.float32)
    return np.stack([np.asarray(t[1], np.float32) for t in entries])


def match_corner_sets(ref: np.ndarray, ours: np.ndarray, center_tol: float = 0.5):
    """Optimal one-to-one nearest-center matching; returns (pairs,
    max_corner_err).  Raises AssertionError with a readable diff when the
    counts differ or a box has no counterpart within ``center_tol`` of its
    center.  For deterministic regimes (trained checkpoints, oracles)."""
    from scipy.optimize import linear_sum_assignment

    assert ref.shape[0] == ours.shape[0], (
        f"world box count differs: reference {ref.shape[0]} vs ours "
        f"{ours.shape[0]}\nref centers:\n{ref.mean(1)}\nours centers:\n{ours.mean(1)}"
    )
    n = ref.shape[0]
    if n == 0:
        return [], 0.0
    cr, co = ref.mean(axis=1), ours.mean(axis=1)
    d = np.linalg.norm(cr[:, None] - co[None, :], axis=-1)
    rows, cols = linear_sum_assignment(d)
    bad = d[rows, cols] > center_tol
    assert not bad.any(), (
        f"{bad.sum()}/{n} boxes have no counterpart within {center_tol} m: "
        + "; ".join(f"ref {i} center {cr[i]} <-> ours {j} at {d[i, j]:.3f} m"
                    for i, j in zip(rows[bad][:5], cols[bad][:5]))
    )
    pairs = list(zip(rows.tolist(), cols.tolist()))
    err = max(float(np.abs(ref[i] - ours[j]).max()) for i, j in pairs)
    return pairs, err


def bounded_match_stats(ref: np.ndarray, ours: np.ndarray, exact_tol: float = 0.05) -> dict:
    """Statistics of the bounded (random-checkpoint) regime: count_rel_diff,
    exact_frac (the share of optimally matched pairs whose largest corner
    error is below ``exact_tol``) and the symmetric nearest-neighbour
    center-distance median / p90."""
    from scipy.optimize import linear_sum_assignment

    nr, no = ref.shape[0], ours.shape[0]
    out = {"n_ref": nr, "n_ours": no, "count_rel_diff": abs(nr - no) / max(nr, no, 1)}
    if nr == 0 or no == 0:
        out.update(exact_frac=0.0, nn_median=np.inf, nn_p90=np.inf)
        return out
    cr, co = ref.mean(axis=1), ours.mean(axis=1)
    d = np.linalg.norm(cr[:, None] - co[None, :], axis=-1)
    rows, cols = linear_sum_assignment(d)
    cerr = np.array([np.abs(ref[i] - ours[j]).max() for i, j in zip(rows, cols)])
    nn = np.concatenate([d.min(axis=1), d.min(axis=0)])
    out.update(exact_frac=float((cerr < exact_tol).mean()), nn_median=float(np.median(nn)),
               nn_p90=float(np.percentile(nn, 90)))
    return out
