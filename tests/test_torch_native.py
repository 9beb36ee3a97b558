"""The port's native loader against the JAX package's and against PIL.

The port builds its own copy of ``loader.cc`` (byte-identical to the JAX
package's, tests/test_torch_package.py) into ``boxfusion_tpu_torch/_build/``.
Held here, on the cases of tests/test_native.py: PNG rgb8 and uint16 and
JPEG decode equal to the JAX loader's bit for bit (PNG also to PIL's; JPEG
within a mean of 2 levels of PIL's, another libjpeg); bilinear resize of
uint8 RGB and float32 depth equal to the JAX loader's and to a numpy model
of the cv2 convention (1 level / 1e-5); a corrupt JPEG raises ValueError;
the Prefetcher keeps order and re-raises a producer's error.  The port's
``CA1MDataset`` on its native branch equals JAX's on its own (equal
arrays), with and without a colour-to-depth resize; and a failed build
leaves ``get_loader()`` None with the compiler's reason kept, the readers
then decoding with PIL.
"""
import dataclasses
import io

import numpy as np
import pytest
from PIL import Image

from boxfusion_tpu.data.readers import CA1MDataset as JaxCA1MDataset
from boxfusion_tpu.native import get_loader as jax_get_loader
from boxfusion_tpu.utils.config import load_config as jax_load_config

import boxfusion_tpu_torch.native.loader as port_loader
from boxfusion_tpu_torch.data.readers import CA1MDataset, write_ca1m_sequence
from boxfusion_tpu_torch.data.synthetic import SyntheticSequence
from boxfusion_tpu_torch.native import Prefetcher, build_error, get_loader, native_available
from boxfusion_tpu_torch.utils.config import load_config

nl, jl = get_loader(), jax_get_loader()
needs_native = pytest.mark.skipif(nl is None or jl is None, reason=f"native loader unavailable: {build_error()}")


def _encode(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


@needs_native
@pytest.mark.parametrize("case", ["rgb8", "u16"])
def test_decode_png_matches_jax_and_pil(case):
    rng = np.random.RandomState(0 if case == "rgb8" else 1)
    img = (rng.randint(0, 255, (37, 53, 3), np.uint8) if case == "rgb8"
           else (rng.rand(24, 31) * 60000).astype(np.uint16))
    data = _encode(img, "PNG")
    got = nl.decode_png(data)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jl.decode_png(data))
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))


@needs_native
def test_decode_jpeg_matches_jax_and_pil():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 255, (40, 60, 3), np.uint8)
    data = _encode(img, "JPEG", quality=95)
    got = nl.decode_jpeg(data)
    assert got.shape == (40, 60, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jl.decode_jpeg(data))
    want = np.asarray(Image.open(io.BytesIO(data)))
    assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 2.0


def _np_bilinear(img, dh, dw):
    """cv2-convention bilinear (half-pixel centers, clamped edges);
    tests/test_native.py's model."""
    sh, sw = img.shape[:2]
    fy = (np.arange(dh) + 0.5) * sh / dh - 0.5
    fx = (np.arange(dw) + 0.5) * sw / dw - 0.5
    y0 = np.clip(np.floor(fy), 0, sh - 1).astype(int)
    x0 = np.clip(np.floor(fx), 0, sw - 1).astype(int)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = np.clip(fy - y0, 0, 1)[:, None]
    wx = np.clip(fx - x0, 0, 1)[None, :]
    if img.ndim == 3:
        wy, wx = wy[..., None], wx[..., None]
    a, b = img[np.ix_(y0, x0)].astype(np.float64), img[np.ix_(y0, x1)].astype(np.float64)
    c, d = img[np.ix_(y1, x0)].astype(np.float64), img[np.ix_(y1, x1)].astype(np.float64)
    return (a * (1 - wx) + b * wx) * (1 - wy) + (c * (1 - wx) + d * wx) * wy


@needs_native
@pytest.mark.parametrize("size_wh", [(32, 24), (128, 96)], ids=["down", "up"])
def test_resize_matches_jax_and_bilinear(size_wh):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (48, 64, 3), np.uint8)
    d = rng.rand(48, 64).astype(np.float32)
    w, h = size_wh
    got = nl.resize_rgb(img, size_wh)
    np.testing.assert_array_equal(got, jl.resize_rgb(img, size_wh))
    assert np.max(np.abs(got.astype(float) - _np_bilinear(img, h, w))) <= 1.0  # u8 truncation
    got = nl.resize_f32(d, size_wh)
    np.testing.assert_array_equal(got, jl.resize_f32(d, size_wh))
    np.testing.assert_allclose(got, _np_bilinear(d, h, w), atol=1e-5)
    assert nl.resize_rgb(img, (64, 48)) is img  # same size: no copy, as JAX


@needs_native
def test_corrupt_jpeg_raises_value_error():
    with pytest.raises(ValueError):
        nl.decode_jpeg(b"\xff\xd8\xff\xe0garbage-not-a-jpeg")
    with pytest.raises(ValueError):
        nl.decode_png(b"\x89PNG\r\n\x1a\nnot-a-png")


def test_prefetcher_order_and_error_propagation():
    assert list(Prefetcher(list(range(50)), depth=4)) == list(range(50))

    def gen():
        yield 1
        raise IOError("decode failed")

    it = iter(Prefetcher(gen()))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="prefetch producer") as info:
        list(it)
    assert isinstance(info.value.__cause__, IOError)


@needs_native
@pytest.mark.parametrize("depth_div", [1, 2], ids=["same_size", "depth_half"])
def test_ca1m_native_branch_matches_jax(tmp_path, depth_div):
    assert native_available() and build_error() is None
    frames = [dataclasses.replace(f, depth=f.depth[::depth_div, ::depth_div].copy())
              for f in SyntheticSequence(n_frames=3, n_boxes=2, seed=0)]
    assert write_ca1m_sequence(frames, str(tmp_path)) == 3
    overrides = {"data": {"datadir": str(tmp_path)}}
    got = list(CA1MDataset(load_config("config/ca1m.yaml", overrides)))
    want = list(JaxCA1MDataset(jax_load_config("config/ca1m.yaml", overrides)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field in ("image", "depth", "K", "K_depth", "T_gravity", "gt_pose"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field), err_msg=field)


def test_failed_build_is_visible_and_readers_fall_back(tmp_path, monkeypatch):
    """A build that fails (here: a flag g++ refuses) leaves get_loader()
    None and keeps the compiler's reason; the reader then decodes with PIL."""
    monkeypatch.setattr(port_loader, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_loader, "GXX_FLAGS", port_loader.GXX_FLAGS + ("-fno-such-option-here",))
    for name, value in (("_loader", None), ("_tried", False), ("_error", None)):
        monkeypatch.setattr(port_loader, name, value)
    assert port_loader.get_loader() is None and not port_loader.native_available()
    reason = port_loader.build_error()
    assert reason and "g++" in reason
    import boxfusion_tpu.data.readers as jax_readers

    monkeypatch.setattr(jax_readers, "_native", lambda: None)  # JAX on PIL too
    write_ca1m_sequence(list(SyntheticSequence(n_frames=2, n_boxes=2, seed=1)), str(tmp_path / "seq"))
    overrides = {"data": {"datadir": str(tmp_path / "seq")}}
    got = list(CA1MDataset(load_config("config/ca1m.yaml", overrides)))
    want = list(JaxCA1MDataset(jax_load_config("config/ca1m.yaml", overrides)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in ("image", "depth", "K"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field), err_msg=field)
