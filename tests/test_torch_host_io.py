"""The port's host input layer on the CPU, against the JAX package: the
host library's archive reader (``data/native_io``, ``csrc/scdio.cpp``),
its batch packer and grayscale, its build (``core/cuda_build``) and the
build cache (``core/compile_cache``).

Every comparison is exact: the readers, the packer and the grayscale
move or compute the same bits (float64 payloads cast to float32 once,
in both readers; the grayscale in float64 in numpy's order, rounded
half to even).
"""

import ctypes
import io
import json
import os
import zipfile
from pathlib import Path

import numpy as np
import pytest

from scd_resnet_tpu.core.compile_cache import (
    host_fingerprint as jax_host_fingerprint,
)
from scd_resnet_tpu.data.archive import read_archive as jax_read_archive
from scd_resnet_tpu.data.native_io import (
    read_archive_native as jax_read_archive_native,
)
from scd_resnet_tpu.ops.image import (
    grayscale_inference_u8 as jax_grayscale_inference_u8,
)
from scd_resnet_tpu_torch.core import compile_cache, cuda_build
from scd_resnet_tpu_torch.data import native_io
from scd_resnet_tpu_torch.data.archive import MAXTAGLEN, read_archive
from scd_resnet_tpu_torch.ops.image import (
    grayscale_inference_u8,
    grayscale_inference_u8_plain,
)

import torch_port_common  # noqa: F401  (the CPU-thread rule)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 64
# objects a clip holds: none, one, MAXTAGLEN, one more (dropped)
OBJECTS = (0, 1, 30, 31)


def _npy(array) -> bytes:
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


def _write_archive(path, clips, stored=()):
    """A `.d` zip of ``clips`` = [(name, sample, locs)], the entries in
    ``stored`` written uncompressed (method 0), the others deflated."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, sample, locs in clips:
            for kind, array in (("samples", sample), ("locs", locs)):
                entry = "{}/{}".format(kind, name)
                zf.writestr(entry, _npy(array), compress_type=(
                    zipfile.ZIP_STORED if entry in stored
                    else zipfile.ZIP_DEFLATED))
        zf.writestr("dataset.json",
                    json.dumps({"names": [c[0] for c in clips]}))
        zf.writestr("object-count.json", "{}")


def _seeded_clips(count=40, seed=13):
    """Seeded 64x64 clips: object counts cycling through OBJECTS, clip 5
    an empty 1-D locs array, clip 7's sample and clip 9's locs float64."""
    rng = np.random.default_rng(seed)
    clips = []
    for i in range(count):
        sample = (rng.random((SIDE, SIDE)) * 255).astype(np.float32)
        locs = (rng.random((OBJECTS[i % len(OBJECTS)], 8)) * SIDE).astype(
            np.float32)
        if i == 5:
            locs = np.zeros(0, np.float32)
        if i == 7:
            sample = rng.random((SIDE, SIDE)) * 255
        if i == 9:
            locs = rng.random((3, 8)) * SIDE
        clips.append(("slide{}.{}.{}.npy".format(i % 3, i % 2, i), sample,
                      locs))
    return clips


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("host_io") / "seeded.d")
    _write_archive(path, _seeded_clips(),
                   stored=("samples/slide2.0.2.npy",))
    return path


def _assert_same(got, want):
    assert list(got[0]) == list(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_native_reader_equals_both_jax_readers(archive):
    with zipfile.ZipFile(archive) as zf:
        kinds = {i.filename: i.compress_type for i in zf.infolist()}
    assert kinds["samples/slide2.0.2.npy"] == zipfile.ZIP_STORED
    native = read_archive(archive)
    _assert_same(native, read_archive(archive, "numpy"))
    _assert_same(native, jax_read_archive(archive, prefer_native=False))
    _assert_same(native, jax_read_archive_native(archive))
    names, samples, locs, counts = native
    assert samples.shape == (40, SIDE, SIDE)
    assert locs.shape == (40, MAXTAGLEN, 8)
    assert counts[:4].tolist() == [0, 1, MAXTAGLEN, MAXTAGLEN]
    assert counts[5] == 0
    assert counts[9] == 3


def test_thread_counts_give_the_same_arrays(archive):
    one = native_io.read_archive_native(archive, threads=1)
    for threads in (3, 64):
        _assert_same(native_io.read_archive_native(archive, threads), one)


@pytest.fixture(scope="module")
def zip64_archive(tmp_path_factory):
    """32,768 clips of 2x2 (65,538 entries): zipfile writes a ZIP64 end
    record, the 16-bit entry count of the plain one saturated."""
    path = str(tmp_path_factory.mktemp("zip64") / "many.d")
    rng = np.random.default_rng(64)
    values = rng.random((32768, 2, 2), np.float32)
    counts = rng.integers(0, 3, 32768)
    header = _npy(values[0])[:-16]
    names = ["s.0.{}.npy".format(i) for i in range(32768)]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for i, name in enumerate(names):
            zf.writestr("samples/" + name, header + values[i].tobytes())
            zf.writestr("locs/" + name, _npy(np.full((counts[i], 8), i,
                                                     np.float32)))
        zf.writestr("dataset.json", json.dumps({"names": names}))
    return path


def test_zip64_archive_reads_as_the_numpy_reader(zip64_archive):
    tail = open(zip64_archive, "rb").read()[-200:]
    assert b"PK\x06\x06" in tail and b"PK\x06\x07" in tail  # ZIP64 records
    native = read_archive(zip64_archive)
    _assert_same(native, read_archive(zip64_archive, "numpy"))
    assert native[1].shape == (32768, 2, 2)


def test_zip64_extra_fields(tmp_path, monkeypatch):
    """Entries whose sizes and offsets zipfile records in ZIP64 extra
    fields (its ZIP64 limit lowered to 100 bytes for the write)."""
    path = str(tmp_path / "extra.d")
    monkeypatch.setattr(zipfile, "ZIP64_LIMIT", 100)
    _write_archive(path, _seeded_clips(count=6, seed=5))
    monkeypatch.undo()
    with zipfile.ZipFile(path) as zf:
        assert any(i.file_size > 100 and b"\x01\x00" in i.extra[:2]
                   for i in zf.infolist())
    _assert_same(read_archive(path), read_archive(path, "numpy"))


def test_corrupt_and_truncated_archives_raise(tmp_path):
    bad = tmp_path / "bad.d"
    bad.write_bytes(b"\x00" * 4096)
    with pytest.raises(ValueError, match="not a readable zip"):
        read_archive(str(bad))
    good = tmp_path / "good.d"
    _write_archive(str(good), _seeded_clips(count=4, seed=1))
    data = good.read_bytes()
    trunc = tmp_path / "trunc.d"
    trunc.write_bytes(data[: len(data) // 3] + data[-100:])
    with pytest.raises(ValueError, match="not a readable zip"):
        read_archive(str(trunc))


def test_a_bad_entry_raises_with_its_index_and_name(tmp_path):
    clips = _seeded_clips(count=4, seed=2)
    flipped = str(tmp_path / "flipped.d")
    _write_archive(flipped, clips, stored=("samples/slide2.0.2.npy",))
    data = bytearray(open(flipped, "rb").read())
    with zipfile.ZipFile(flipped) as zf:
        info = zf.getinfo("samples/slide2.0.2.npy")
    data[info.header_offset + 30 + len(info.filename) + 200] ^= 0xFF
    with open(flipped, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match=r"entry 2 \(slide2\.0\.2\.npy\): "
                       r"samples/slide2\.0\.2\.npy .*CRC"):
        read_archive(flipped)

    clips[3] = (clips[3][0], clips[3][1], np.zeros((2, 7), np.float32))
    wide = str(tmp_path / "wide.d")
    _write_archive(wide, clips)
    with pytest.raises(ValueError, match=r"entry 3 \(slide0\.1\.3\.npy\): "
                       r"locs/slide0\.1\.3\.npy is a <f4 array of shape "
                       r"\(2, 7\)"):
        read_archive(wide)
    clips[3] = (clips[3][0], clips[3][1].astype(np.float16),
                np.zeros((1, 8), np.float32))
    half = str(tmp_path / "half.d")
    _write_archive(half, clips)
    with pytest.raises(ValueError, match=r"entry 3 .* is a <f2 array"):
        read_archive(half)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build root of its own and no library loaded yet."""
    monkeypatch.setattr(cuda_build, "_root", tmp_path / "root")
    monkeypatch.setattr(cuda_build, "_libraries", {})
    monkeypatch.setattr(native_io, "_lib", None)
    return tmp_path


def test_a_failed_build_raises_with_the_compiler_output(fresh_build,
                                                        monkeypatch, archive):
    cxx = fresh_build / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'planted compiler failure' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="planted compiler failure"):
        read_archive(archive)
    with pytest.raises(RuntimeError, match="planted compiler failure"):
        grayscale_inference_u8(np.zeros((2, 2, 3), np.uint8))
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        read_archive(archive)
    assert not list((fresh_build / "root").rglob("*.so"))


def test_a_stale_library_raises(fresh_build, monkeypatch, archive):
    monkeypatch.setattr(cuda_build, "load",
                        lambda source: ctypes.CDLL("libz.so.1"))
    with pytest.raises(RuntimeError, match="scdio_open.*stale"):
        read_archive(archive)


def test_library_builds_under_build_with_fp_contract_off():
    assert "-ffp-contract=off" in cuda_build.HOST_FLAGS
    lib = native_io.get_library()
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.join(REPO, "build") + os.sep)
    assert os.sep + "native" + os.sep not in path
    assert os.path.dirname(path) == str(cuda_build.build_root() / "host")


def test_gather_batch_equals_np_take(archive):
    _, samples, _, _ = read_archive(archive)
    idx = np.array([3, 0, 39, 7, 7], np.int64)
    want = np.take(samples, idx, axis=0)
    assert native_io.gather_batch(samples, idx).tobytes() == want.tobytes()
    out = np.empty_like(want)
    assert native_io.gather_batch(samples, idx, out) is out
    assert out.tobytes() == want.tobytes()
    for bad in (40, -1):
        with pytest.raises(IndexError):
            native_io.gather_batch(samples, np.array([bad]))
    with pytest.raises(TypeError):
        native_io.gather_batch(samples.astype(np.float16), idx)


def test_grayscale_equals_jax_bit_for_bit():
    rng = np.random.default_rng(2056)
    rgb = rng.integers(0, 256, (203, 311, 3), dtype=np.uint8)
    want = jax_grayscale_inference_u8(rgb)
    assert grayscale_inference_u8(rgb).tobytes() == want.tobytes()
    # a non-contiguous view and float input (the plain version)
    rgba = rng.integers(0, 256, (50, 40, 4), dtype=np.uint8)
    assert np.array_equal(grayscale_inference_u8(rgba[..., :3]),
                          jax_grayscale_inference_u8(rgba[..., :3]))
    floats = rgb.astype(np.float32)
    assert np.array_equal(grayscale_inference_u8(floats),
                          jax_grayscale_inference_u8(floats))


def test_grayscale_equals_numpy_on_every_rgb_triple():
    for high in range(0, 256, 64):
        code = np.arange(high << 16, (high + 64) << 16, dtype=np.uint32)
        rgb = np.stack([code >> 16, (code >> 8) & 255, code & 255],
                       -1).astype(np.uint8)
        assert np.array_equal(grayscale_inference_u8(rgb),
                              grayscale_inference_u8_plain(rgb))


CPUINFO = (
    "processor\t: 0\nflags\t\t: fpu sse2 avx2 avx512f\n\n"
    "processor\t: 1\nflags\t\t: fpu sse2 avx2 avx512f\n",
    "processor\t: 0\nflags\t\t: avx512f avx2 fpu sse2\n",
    "processor\t: 0\nFeatures\t: fp asimd evtstrm aes\n",
    "processor\t: 0\nmodel name\t: unknown\n",
)


@pytest.mark.parametrize("text", CPUINFO)
def test_host_fingerprint_equals_jax(text):
    assert compile_cache.host_fingerprint(text) == \
        jax_host_fingerprint(text)


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    """No cache variables set, and the build root restored after."""
    monkeypatch.setattr(cuda_build, "_root", cuda_build._root)
    monkeypatch.delenv(compile_cache.BASE_ENV, raising=False)
    monkeypatch.delenv(compile_cache.NO_CACHE_ENV, raising=False)
    return tmp_path


def test_cache_directory_redirect_and_opt_out(cache_env, monkeypatch):
    default = compile_cache.enable_compilation_cache()
    assert default == str(compile_cache.DEFAULT_BASE
                          / compile_cache.fingerprint())
    assert compile_cache.enable_compilation_cache() == default
    assert cuda_build.build_root() == Path(default)

    monkeypatch.setenv(compile_cache.BASE_ENV, str(cache_env / "elsewhere"))
    moved = compile_cache.enable_compilation_cache()
    assert moved == str(cache_env / "elsewhere" / compile_cache.fingerprint())
    assert compile_cache.enable_compilation_cache(str(cache_env / "given")) \
        .startswith(str(cache_env / "given") + os.sep)

    monkeypatch.setenv(compile_cache.NO_CACHE_ENV, "1")
    fresh = compile_cache.enable_compilation_cache()
    assert os.path.dirname(fresh) == str(cache_env / "elsewhere")
    assert os.path.basename(fresh).startswith("nocache-")
    assert compile_cache.enable_compilation_cache() == fresh
    assert cuda_build.build_root() == Path(fresh)
    key = (str(cache_env / "elsewhere"), os.getpid())
    compile_cache._remove_fresh(key)
    assert not os.path.exists(fresh)


def test_a_new_nvcc_moves_the_cache(cache_env, monkeypatch):
    before = compile_cache.enable_compilation_cache(str(cache_env))
    bin_dir = cache_env / "bin"
    bin_dir.mkdir()
    for release in ("12.9", "13.0"):
        nvcc = bin_dir / "nvcc"
        nvcc.write_text("#!/bin/sh\necho 'Cuda compilation tools, release "
                        "{}'\n".format(release))
        nvcc.chmod(0o755)
        monkeypatch.setenv("PATH", str(bin_dir) + os.pathsep
                           + os.environ["PATH"])
        after = compile_cache.enable_compilation_cache(str(cache_env))
        assert after != before
        before = after
    assert os.path.basename(after).split("-")[0] == \
        compile_cache.host_fingerprint()


def test_entry_points_enable_the_cache():
    """Each entry point whose JAX twin enables XLA's cache enables the
    build cache."""
    for module in ("serve", "test", "trace", "preprocess",
                   "train/__main__", "tools/eval_checkpoint",
                   "tools/f1_pipeline"):
        with open(os.path.join(REPO, "scd_resnet_tpu_torch",
                               module + ".py")) as f:
            assert "enable_compilation_cache()" in f.read(), module
