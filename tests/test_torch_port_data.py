"""The port's host data pipeline against the JAX package's: EMODataset and
its helpers, the segmentation masks, the box-mean downsample, and the
prefetch on the CPU.

Both packages decode the same synthetic mp4s (written with cv2, 96x96) into
their own npz caches; everything is held equal bit for bit, except the box
mean against cv2's INTER_AREA, which sums in another order (1e-6 absolute
on [0, 1] images; measured 0 at x2 and 1.8e-7 at x4).
"""

import json
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from megaportraits_tpu.data import dataset as jdataset
from megaportraits_tpu.data import segmentation as jsegmentation

from megaportraits_tpu_torch.data import dataset as tdataset
from megaportraits_tpu_torch.data import segmentation as tsegmentation
from megaportraits_tpu_torch.data.prefetch import prefetch_to_device

CLIPS = ("clip_a", "clip_b", "clip_c")
SIZE = 64


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:96]
    for n, vid in enumerate(CLIPS):
        writer = cv2.VideoWriter(str(d / f"{vid}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 25, (96, 96))
        base = rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)
        # A skin-toned disc, so that the face heuristic finds a box.
        disc = (yy - 48) ** 2 + (xx - 40 - 4 * n) ** 2 < 30 ** 2
        base[disc] = (120, 150, 200)  # BGR
        for i in range(50):
            writer.write(np.roll(base, i, axis=1))
        writer.release()
    with open(d / "meta.json", "w") as f:
        json.dump({"clips": {vid: {} for vid in CLIPS}}, f)
    return d


def _datasets(video_dir, tmp_path, **kw):
    """(JAX dataset, port dataset) over the same clips, caching apart."""
    out = []
    for module, name in ((jdataset, "jax"), (tdataset, "port")):
        cache = tmp_path / name
        cache.mkdir()
        out.append(module.EMODataset(
            width=SIZE, height=SIZE, n_sample_frames=4, sample_rate=10,
            video_dir=str(video_dir), json_file=str(video_dir / "meta.json"),
            cache_dir=str(cache), **kw))
    return out


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [
    dict(driving_mode="cross_frame"),
    dict(driving_mode="separate_video", seed=3),
    dict(driving_mode="cross_frame", apply_crop_warping=False, seed=1),
    dict(driving_mode="cross_frame", remove_background_flag=True, use_greenscreen=True),
], ids=["cross_frame", "separate_video", "no_warp", "greenscreen"])
def test_emodataset_matches_jax_bit_for_bit(video_dir, tmp_path, kw):
    jds, tds = _datasets(video_dir, tmp_path, **kw)
    assert tds.video_ids == jds.video_ids == list(CLIPS)
    assert tds.driving_video_ids == jds.driving_video_ids
    for vid in CLIPS:
        # GrabCut seeds its k-means from cv2's global generator.
        cv2.setRNGSeed(0)
        jds.load_and_process_video(vid)
        cv2.setRNGSeed(0)
        tds.load_and_process_video(vid)
        name = f"{vid}_{SIZE}x{SIZE}_tensors.npz"
        jcache, tcache = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
        assert sorted(tcache.files) == sorted(jcache.files) == ["driving_frames", "source_frames"]
        for k in jcache.files:
            np.testing.assert_array_equal(tcache[k], jcache[k])
    for i in range(len(CLIPS)):
        _assert_items_equal(tds[i], jds[i])
    for holdout in (0, 1):
        jb = jds.frame_batches(3, frame_offset=2, seed=5, holdout=holdout)
        tb = tds.frame_batches(3, frame_offset=2, seed=5, holdout=holdout)
        for _ in range(3):
            _assert_items_equal(next(tb), next(jb))


def test_emodataset_reads_its_cache_without_cv2(video_dir, tmp_path, monkeypatch):
    """A cache hit needs neither cv2 nor PIL: the card's machine has none."""
    _, tds = _datasets(video_dir, tmp_path)
    want = tds.load_and_process_video("clip_b")
    monkeypatch.setattr(tdataset, "cv2", None)
    again = tdataset.EMODataset(
        width=SIZE, height=SIZE, video_dir=str(video_dir),
        json_file=str(video_dir / "meta.json"), cache_dir=str(tmp_path / "port"))
    _assert_items_equal(again.load_and_process_video("clip_b"), want)


def _frame(seed, size=80):
    return np.random.default_rng(seed).uniform(0, 1, (size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_tps_warp_matches_jax(seed):
    frame = _frame(seed)
    got = tdataset.tps_warp(frame, np.random.default_rng(seed), 0.02)
    want = jdataset.tps_warp(frame, np.random.default_rng(seed), 0.02)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box", [None, (10, 12, 30, 40)])
def test_sweet_spot_crop_matches_jax(box):
    frame = _frame(2, 96)
    np.testing.assert_array_equal(tdataset.sweet_spot_crop(frame, (48, 48), box),
                                  jdataset.sweet_spot_crop(frame, (48, 48), box))


def test_augment_pair_and_masks_for_batch_match_jax():
    frames = np.stack([_frame(s, 48) for s in range(3)])
    np.testing.assert_array_equal(
        tdataset.augment_pair(frames, np.random.default_rng(4)),
        jdataset.augment_pair(frames, np.random.default_rng(4)))
    cv2.setRNGSeed(0)
    want = jsegmentation.masks_for_batch(frames)
    cv2.setRNGSeed(0)
    got = tsegmentation.masks_for_batch(frames)
    assert got.shape == (3, 48, 48, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor", [2, 4])
def test_area_downsample_matches_cv2_inter_area(factor):
    frames = np.stack([_frame(s, 64) for s in range(3)])
    size = (64 // factor, 64 // factor)
    got = tdataset.area_downsample(frames, size)
    want = np.stack([cv2.resize(f, size, interpolation=cv2.INTER_AREA) for f in frames])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_area_downsample_rejects_a_fractional_factor():
    with pytest.raises(ValueError, match="integer factor"):
        tdataset.area_downsample(np.zeros((2, 64, 64, 3), np.float32), (48, 48))


def test_prefetch_on_the_cpu_keeps_order_and_ends():
    items = [{"a": np.full((2,), i, np.float32), "b": [np.arange(i + 1, dtype=np.int32)]}
             for i in range(5)]
    out = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(out) == 5
    for i, item in enumerate(out):
        assert isinstance(item["a"], torch.Tensor) and item["a"].device.type == "cpu"
        np.testing.assert_array_equal(item["a"].numpy(), np.full((2,), i, np.float32))
        assert item["b"][0].dtype == torch.int32
        np.testing.assert_array_equal(item["b"][0].numpy(), np.arange(i + 1))


def test_prefetch_raises_the_producers_exception_in_the_consumer():
    def batches():
        yield {"a": np.zeros(1, np.float32)}
        raise RuntimeError("decode failed")

    it = prefetch_to_device(batches(), device="cpu")
    assert next(it)["a"].shape == (1,)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetch_stops_its_producer_when_closed():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield {"a": np.full((1,), i, np.float32)}
            i += 1

    it = prefetch_to_device(endless(), size=2, device="cpu")
    assert next(it)["a"].item() == 0
    it.close()
    time.sleep(0.5)
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n <= 5
