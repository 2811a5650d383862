"""The port's PNG decoder and host IO (thermal3d_torch.native,
thermal3d_torch.preprocess.io, thermal3d_torch.data.pipeline) against cv2 and
the JAX package's libpng loader (thermal3d.native): full-resolution samples
equal cv2's, resized batches bit-equal to the JAX loader's, every filter type
and format, and the drop-on-failure contract."""

import cv2
import numpy as np
import pytest

from tests.test_torch_common import encode_png, png_chunk
from thermal3d import native as jax_native
from thermal3d.data import pipeline as jax_pipeline
from thermal3d.preprocess import io as jax_io
from thermal3d_torch import native
from thermal3d_torch.data import pipeline
from thermal3d_torch.kernels import _build
from thermal3d_torch.preprocess import io

SIZES = ((224, 224), (37, 53), (512, 512))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _images(seed=0):
    """name → sample array of each format the files are written in."""
    rng = _rng(seed)
    ramp = np.linspace(0, 1, 53, dtype=np.float32)[None, :]
    thermal = (21000 + 5000 * (0.6 * ramp + 0.4 * rng.uniform(size=(37, 53)))).astype(np.uint16)
    return {
        "gray16": thermal,
        "gray16_dark": rng.integers(0, 200, (30, 41)).astype(np.uint16),
        "gray8": rng.integers(0, 256, (40, 48)).astype(np.uint8),
        "rgb8": rng.integers(0, 256, (33, 45, 3)).astype(np.uint8),
        "rgba8": rng.integers(0, 256, (33, 45, 4)).astype(np.uint8),
        "rgb16": rng.integers(0, 65536, (29, 31, 3)).astype(np.uint16),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """cv2-written files of each format (cv2 picks its own filters), a
    PIL-written palette file, and hand-built files that cycle the five filter
    types: name → path."""
    from PIL import Image

    d = tmp_path_factory.mktemp("png")
    out = {}
    for name, arr in _images().items():
        # cv2 writes channels in BGR(A) order; decoders must swap them back
        src = arr if arr.ndim == 2 else arr[..., [2, 1, 0, 3][:arr.shape[-1]]]
        p = str(d / f"cv2_{name}.png")
        cv2.imwrite(p, src)
        out[f"cv2_{name}"] = p
        color = {2: "gray", 3: "rgb"}[arr.ndim] if arr.ndim == 2 or arr.shape[-1] == 3 \
            else "rgba"
        depth = 16 if arr.dtype == np.uint16 else 8
        out[f"own_{name}"] = _write(d / f"own_{name}.png", encode_png(arr, color, depth))
    rng = _rng(1)
    pal = Image.fromarray(rng.integers(0, 256, (41, 39, 3)).astype(np.uint8)).convert(
        "P", palette=Image.ADAPTIVE, colors=200)
    out["pil_palette"] = str(d / "pil_palette.png")
    pal.save(out["pil_palette"])
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    out["own_palette4"] = _write(d / "own_palette4.png", encode_png(
        rng.integers(0, 16, (23, 27)), "palette", 4, palette=palette))
    out["own_gray2"] = _write(d / "own_gray2.png", encode_png(
        rng.integers(0, 4, (19, 21)), "gray", 2))
    out["own_gray_alpha16"] = _write(d / "own_gray_alpha16.png", encode_png(
        rng.integers(0, 65536, (17, 18, 2)), "gray_alpha", 16))
    return out


def _filtered_files(d, arr, color, depth, **kw):
    """One file per filter type (each row the same filter) and one cycling them."""
    return [_write(d / f"f{f}_{color}{depth}.png", encode_png(arr, color, depth, (f,), **kw))
            for f in range(5)] + [
        _write(d / f"fall_{color}{depth}.png", encode_png(arr, color, depth, **kw))]


@pytest.mark.parametrize("name", ["gray16", "gray16_dark", "gray8"])
def test_full_resolution_equals_cv2_anydepth(files, name):
    """Gray frames at full resolution: the raw samples equal
    cv2.imread(IMREAD_ANYDEPTH), and load_thermal_image equals the JAX one."""
    for src in ("cv2", "own"):
        path = files[f"{src}_{name}"]
        img, depth = native.decode_png(path)
        ref = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        assert depth == (16 if ref.dtype == np.uint16 else 8)
        np.testing.assert_array_equal(img[..., 0], ref.astype(np.float32))
        for normalize in (True, False):
            np.testing.assert_array_equal(io.load_thermal_image(path, normalize),
                                          jax_io.load_thermal_image(path, normalize))


def test_dark_uint16_scales_by_65535(files):
    """The scale follows the decoded type: a 16-bit frame whose maximum is
    under 255 still divides by 65535."""
    img = io.load_thermal_image(files["cv2_gray16_dark"])
    raw = cv2.imread(files["cv2_gray16_dark"], cv2.IMREAD_ANYDEPTH)
    assert raw.max() < 255
    np.testing.assert_array_equal(img, raw.astype(np.float32) / 65535.0)


@pytest.mark.parametrize("name", ["cv2_rgb8", "own_rgb8", "cv2_rgba8", "own_rgba8",
                                  "pil_palette", "own_palette4"])
def test_rgb_full_resolution_equals_cv2(files, name):
    """load_rgb_image: cv2's colour decode (alpha dropped, palette expanded)
    over 255, as the JAX load_rgb_image returns it."""
    np.testing.assert_array_equal(io.load_rgb_image(files[name]),
                                  jax_io.load_rgb_image(files[name]))


@pytest.mark.parametrize("hw", SIZES)
def test_batches_bit_equal_to_jax_loader(files, hw):
    """Every format, decoded and resized as one batch: bit-equal to the JAX
    package's libpng loader, thermal (normalized and raw) and RGB."""
    paths = sorted(files.values())
    for normalize in (True, False):
        got, ok = native.load_thermal_batch(paths, hw, normalize=normalize)
        ref, ref_ok = jax_native.load_thermal_batch(paths, hw, normalize=normalize)
        assert ok.all() and ref_ok.all()
        np.testing.assert_array_equal(got, ref)
    got, ok = native.load_rgb_batch(paths, hw)
    ref, ref_ok = jax_native.load_rgb_batch(paths, hw)
    assert ok.all() and ref_ok.all()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fmt", ["gray8", "gray16", "rgb8", "rgba8", "palette8", "palette2"])
def test_each_filter_type(tmp_path, fmt):
    """Hand-built files whose rows all use one filter type (None, Sub, Up,
    Average, Paeth), and one cycling them: the samples come back exactly and
    the batches are bit-equal to the JAX loader's."""
    rng = _rng(7)
    kw = {}
    if fmt.startswith("palette"):
        depth = int(fmt[-1])
        kw["palette"] = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
        arr = rng.integers(0, 1 << depth, (21, 26))
        want = kw["palette"][arr].astype(np.float32)
        color = "palette"
    else:
        color = fmt[:-1].rstrip("1")
        depth = 16 if fmt.endswith("16") else 8
        c = {"gray": 1, "rgb": 3, "rgba": 4}[color]
        arr = rng.integers(0, 1 << depth, (21, 26, c)).astype(
            np.uint16 if depth == 16 else np.uint8)
        want = arr[..., :3].astype(np.float32)
    paths = _filtered_files(tmp_path, arr, color, depth, **kw)
    for p in paths:
        img, _ = native.decode_png(p)
        np.testing.assert_array_equal(img, want.reshape(img.shape), err_msg=p)
    got, ok = native.load_thermal_batch(paths, (16, 20))
    ref, _ = jax_native.load_thermal_batch(paths, (16, 20))
    assert ok.all()
    np.testing.assert_array_equal(got, ref)


def test_bad_files_give_ok_false_and_are_dropped(files, tmp_path):
    """Corrupt, truncated, CRC-bad, missing and interlaced files give ok=False
    (zero rows) without an exception; the batch loaders drop them and keep
    the order of the rest. The interlaced file is valid: libpng decodes it,
    this decoder refuses it."""
    good = files["cv2_gray16"]
    data = open(good, "rb").read()
    idat = data.index(b"IDAT")
    crc_bad = bytearray(data)
    crc_bad[idat + 10] ^= 0xFF  # a byte of the compressed data: the CRC no longer matches
    rng = _rng(3)
    arr = rng.integers(0, 65536, (19, 23)).astype(np.uint16)
    interlaced = _write(tmp_path / "adam7.png", encode_png(arr, "gray", 16, interlace=True))
    bad = {
        "corrupt": _write(tmp_path / "corrupt.png", b"junk"),
        "truncated": _write(tmp_path / "truncated.png", data[: len(data) // 2]),
        "crc": _write(tmp_path / "crc.png", bytes(crc_bad)),
        "missing": str(tmp_path / "missing.png"),
        "interlaced": interlaced,
        "zlib": _write(tmp_path / "zlib.png", data[:33] + png_chunk(b"IDAT", b"not zlib")
                       + png_chunk(b"IEND", b"")),
    }
    ref, ref_ok = jax_native.load_thermal_batch([interlaced], (8, 8))
    assert ref_ok.all()  # the file is a valid PNG
    paths = [good] + list(bad.values()) + [good]
    out, ok = native.load_thermal_batch(paths, (16, 16))
    assert ok.tolist() == [True] + [False] * len(bad) + [True]
    assert not out[1:-1].any()
    _, rgb_ok = native.load_rgb_batch(paths, (16, 16))
    assert rgb_ok.tolist() == ok.tolist()
    grays, survivors = io.load_thermal_images_batch(paths, out_hw=(16, 16))
    assert survivors == [good, good] and len(grays) == 2
    grays, survivors = io.load_thermal_images_batch(paths)
    assert survivors == [good, good] and grays[0].shape == (37, 53)
    for p in bad.values():
        assert io.load_thermal_image(p) is None and io.load_rgb_image(p) is None


def test_decode_thermal_batch_matches_jax(files, tmp_path):
    paths = [files["cv2_gray16"], _write(tmp_path / "bad.png", b"junk"), files["own_gray8"]]
    got, ok = io.decode_thermal_batch(paths, (20, 24))
    ref, ref_ok = jax_io.decode_thermal_batch(paths, (20, 24))
    assert ok.tolist() == ref_ok.tolist() == [True, False, True]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("call", ["load_thermal_image", "load_rgb_image",
                                  "load_thermal_images_batch", "decode_thermal_batch"])
def test_non_png_paths_raise(call):
    """The port has no decoder for other formats: a clear error, not a drop."""
    fn = getattr(io, call)
    args = {"load_thermal_images_batch": (["a.jpg"],),
            "decode_thermal_batch": (["a.jpg"], (8, 8))}.get(call, ("a.jpg",))
    with pytest.raises(ValueError, match="PNG"):
        fn(*args)


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a compile error, or no compiler, raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host(src)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="not found"):
        _build.build_host(src)
    assert not list((tmp_path / "build").glob("*"))


def test_available_and_build_error_report_the_host_library(monkeypatch):
    """native.available() / build_error() as thermal3d.native's: here the
    library builds, so available() is true and build_error() None; where it
    cannot be built, available() is false, build_error() gives the error's
    text, and library() raises it (they only report: nothing falls back)."""
    assert native.available() and native.build_error() is None
    assert jax_native.available() and jax_native.build_error() is None

    def no_compiler(src):
        raise RuntimeError(f"g++ not found on PATH: {src.name} cannot be built")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_compiler)
    assert not native.available()
    assert native.build_error() == "g++ not found on PATH: png_decode.cpp cannot be built"
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.library()


def test_read_png_skips_bad_ancillary_chunks(files, tmp_path):
    """As libpng: a bad CRC drops an ancillary chunk, and a file that ends
    after its image data (no IEND) still decodes."""
    data = open(files["own_gray8"], "rb").read()
    iend = data.index(b"IEND") - 4
    text = b"tEXt" + b"Comment\x00hi"
    bad_anc = data[:33] + len(text[4:]).to_bytes(4, "big") + text + b"\0\0\0\0" + data[33:]
    for name, blob in (("anc", bad_anc), ("noiend", data[:iend])):
        p = _write(tmp_path / f"{name}.png", blob)
        np.testing.assert_array_equal(native.decode_png(p)[0][..., 0],
                                      cv2.imread(files["own_gray8"], cv2.IMREAD_ANYDEPTH))


def test_pipelined_batches_matches_jax_order():
    """The same decode/dispatch/consume sequence as the JAX pipeline, with a
    skipped chunk: consume(i) runs after dispatch(i+1)."""
    def run(fn):
        events = []

        def decode(c):
            return c

        def dispatch(c):
            events.append(("dispatch", c))
            return None if c == 2 else c

        fn(list(range(5)), decode, dispatch, lambda t: events.append(("consume", t)),
           prefetch=1)
        return events

    got = run(pipeline.pipelined_batches)
    assert got == run(jax_pipeline.pipelined_batches)
    assert got.index(("consume", 0)) > got.index(("dispatch", 1))


def test_split_index_matches_jax():
    for n, frac, seed in ((10, 0.2, 0), (37, 0.3, 5)):
        for a, b in zip(pipeline.split_index(n, frac, seed),
                        jax_pipeline.split_index(n, frac, seed)):
            np.testing.assert_array_equal(a, b)


def test_pinned_fetch_on_cpu_copies_rows_and_guards_sets():
    """On the CPU finish() copies the first rows out; a set is not reused
    while its fetch is unfinished (only CUDA uses sets)."""
    import torch

    fetch = pipeline.PinnedFetch(torch.device("cpu"))
    t = torch.arange(12.0).reshape(4, 3)
    token = fetch.start({"depth": t})
    out = fetch.finish(token, 2)
    np.testing.assert_array_equal(out["depth"], t[:2].numpy())
    t.zero_()
    assert out["depth"].any()  # a copy, not a view
