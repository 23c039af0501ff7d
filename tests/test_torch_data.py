"""The port's training data path (``axial_vs_tpu_torch/data``) against the
JAX package's, on the CPU: the clip transforms, ``VIPSegClipMapper`` with
copy-paste on and off, ``build_mapper`` and the VIPSeg registration, and
``ClipDataLoader``. The copies must be exact: the same seeds give
bit-identical images and targets, and the synchronous loader yields the
JAX loader's batches. The worker loader's start, take and close cycle runs
under ``DataLoader(timeout=...)`` and a hard alarm, so that a stuck worker
fails the test instead of hanging it.
"""
import contextlib
import signal
import threading
import time

import numpy as np
import pytest
import torch

from fixtures_vipseg import synthesize_vipseg_videos

#: frames of the fixture videos, and the training crop (not a multiple of
#: 4 on one side, and smaller than the frame on the other)
FRAME_HW, CROP = (90, 160), (64, 97)
#: seconds the 2-worker cycle may take, and each batch's DataLoader timeout
WORKER_CYCLE_S, BATCH_TIMEOUT_S = 120, 60


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    return synthesize_vipseg_videos(str(tmp_path_factory.mktemp("vipseg")),
                                    n_videos=3, n_frames=5, hw=FRAME_HW)


def _equal_trees(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _equal_trees(a[k], b[k])
        return
    a = a.numpy() if torch.is_tensor(a) else a
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_clip_transforms_are_bit_identical(seed):
    """``build_train_transforms`` sampled from the same RandomState and
    replayed on a frame and its id map: the same arrays."""
    from axial_vs_tpu.data.transforms import build_train_transforms as J
    from axial_vs_tpu_torch.data.transforms import build_train_transforms

    rs = np.random.RandomState(100 + seed)
    img = rs.randint(0, 256, (73 + 9 * seed, 121, 3)).astype(np.uint8)
    seg = rs.randint(0, 5, img.shape[:2]).astype(np.int32)
    outs = []
    for build in (J, build_train_transforms):
        t = build(CROP, 0.3, 1.7)
        t.sample(np.random.RandomState(seed), img.shape[:2])
        outs.append((t.apply_image(img), t.apply_segmentation(seg)))
    for got, want in zip(outs[1], outs[0]):
        _equal_trees(got, want)


@pytest.mark.parametrize("copy_paste", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_vipseg_mapper_is_bit_identical(videos, copy_paste, reverse):
    """Three samples of each mapper from seed 5, copy-paste on and off,
    clip reversal on and off."""
    from axial_vs_tpu.data.vipseg import VIPSegClipMapper as J
    from axial_vs_tpu_torch.data.vipseg import VIPSegClipMapper

    kw = dict(image_size=CROP, num_frames=2, max_instances=6,
              copy_paste=copy_paste, random_reverse=reverse, seed=5,
              category_id_map={3: 1, 5: 2})
    want, got = J(**kw), VIPSegClipMapper(**kw)
    for i in range(3):
        v = videos[i % len(videos)]
        _equal_trees(got(v, dataset=videos), want(v, dataset=videos))


#: the training set the mapper tests name (each side's catalog gets its
#: metadata under this name, which no other test uses)
TRAIN_NAME = "vipseg_torch_data_test_train"


def _config(mapper="auto"):
    from axial_vs_tpu_torch.config import load_config

    return load_config("vipseg/maxtron_wc_r50.yaml", [
        "input.image_size", list(CROP), "input.dataset_mapper_name", mapper,
        "model.kmax.trans_dec.num_object_queries", 8,
        "datasets.train", [TRAIN_NAME]])


def test_build_mapper_and_registration(tmp_path, videos):
    """``builtin.register_all`` registers a VIPSeg split found on disk
    with its categories' maps; with those maps ``build_mapper`` builds the
    JAX package's mapper for the same config: bit-identical samples."""
    import json

    from axial_vs_tpu.data.build import build_mapper as jax_build
    from axial_vs_tpu.data.catalog import MetadataCatalog as JM
    from axial_vs_tpu_torch.data import builtin
    from axial_vs_tpu_torch.data.build import build_mapper
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

    base = tmp_path / "VIPSeg"
    base.mkdir()
    cats = [dict(id=i, name=f"c{i}", isthing=int(i < 4)) for i in range(8)]
    with open(base / "panoVIPSeg_train.json", "w") as f:
        json.dump(dict(videos=[], categories=cats), f)
    name = "panoVSPW_vps_video_train"
    if name not in DatasetCatalog:
        assert builtin.register_all(str(tmp_path)) == [name]
    meta = MetadataCatalog.get(name)
    assert meta.thing_dataset_id_to_contiguous_id == {i: i for i in range(4)}
    assert meta.stuff_dataset_id_to_contiguous_id == {i: i for i in range(4, 8)}
    cfg = _config()
    for catalog in (MetadataCatalog, JM):
        for k in ("thing_dataset_id_to_contiguous_id",
                  "stuff_dataset_id_to_contiguous_id"):
            catalog.get(TRAIN_NAME)[k] = dict(meta[k])
    got, want = build_mapper(cfg, seed=3), jax_build(cfg, seed=3)
    assert type(got).__module__ == "axial_vs_tpu_torch.data.vipseg"
    assert got.category_id_map == want.category_id_map
    for v in videos[:2]:
        _equal_trees(got(v, dataset=videos), want(v, dataset=videos))


@pytest.mark.parametrize("name", ["coco_panoptic", "coco_instance", "ytvis",
                                  "dvps"])
def test_unported_mappers_raise(name):
    from axial_vs_tpu_torch.data.build import build_mapper

    with pytest.raises(NotImplementedError, match=name):
        build_mapper(_config(name))


def test_synchronous_loader_yields_the_jax_batches(videos):
    """``num_workers=0``: three batches of two clips, equal to the JAX
    ``ClipDataLoader(num_workers=0)``'s from the same seeds."""
    from axial_vs_tpu.data.loader import ClipDataLoader as J
    from axial_vs_tpu.data.vipseg import VIPSegClipMapper as JMapper
    from axial_vs_tpu_torch.data.loader import ClipDataLoader
    from axial_vs_tpu_torch.data.vipseg import VIPSegClipMapper

    kw = dict(image_size=CROP, num_frames=2, max_instances=6, seed=1)
    want = J(videos, JMapper(**kw), batch_size=2, num_workers=0, seed=4)
    got = ClipDataLoader(videos, VIPSegClipMapper(**kw), batch_size=2,
                         num_workers=0, seed=4)
    for w, g in zip(iter(want), iter(got)):
        _equal_trees(g, w)
        assert g["images"].shape == (4, *CROP, 3)
        break
    jw, pw = iter(want), iter(got)
    for _ in range(3):
        _equal_trees(next(pw), next(jw))


@contextlib.contextmanager
def _alarm(seconds):
    """Raise TimeoutError in this (main) thread after ``seconds``."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def fire(signum, frame):
        raise TimeoutError(f"the loader cycle took over {seconds} s")

    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def test_worker_loader_starts_takes_and_closes(videos):
    """Two worker processes: two batches arrive within the DataLoader's
    timeout, each one of the workers' own first batches (worker w draws
    from RandomState(seed * 1000 + w), with its own copy of the mapper);
    ``close()`` stops both workers."""
    from axial_vs_tpu_torch.data.loader import ClipDataLoader, _make_batch
    from axial_vs_tpu_torch.data.vipseg import VIPSegClipMapper

    kw = dict(image_size=CROP, num_frames=2, max_instances=6, seed=1)
    firsts = [_make_batch(videos, VIPSegClipMapper(**kw), 1,
                          np.random.RandomState(2 * 1000 + wid))
              for wid in range(2)]
    t0 = time.perf_counter()
    with _alarm(WORKER_CYCLE_S):
        loader = ClipDataLoader(videos, VIPSegClipMapper(**kw), batch_size=1,
                                num_workers=2, prefetch=1, seed=2,
                                timeout=BATCH_TIMEOUT_S)
        it = iter(loader)
        batches = [next(it) for _ in range(2)]
        workers = loader.workers()
        assert len(workers) == 2 and all(w.is_alive() for w in workers)
        loader.close()
    assert not any(w.is_alive() for w in workers)
    assert time.perf_counter() - t0 < WORKER_CYCLE_S
    for b in batches:
        matches = 0
        for f in firsts:
            try:
                _equal_trees(b, f)
                matches += 1
            except AssertionError:
                pass
        assert matches >= 1
