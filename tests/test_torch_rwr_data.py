"""The RWR dataset across the two packages, on the CPU.

Split files that the port's ``RemoteWriter`` writes are read by
``ddpo_tpu.data.hdf5.RemoteReader`` and files that ``ddpo_tpu`` writes are
read by the port's: every field equal (the JPEG-decoded images and the
pickled prompt lists too), with each package's ``sizes.pkl`` manifest equal
to the other's, and a seeded ``collate_fn`` batch equal. No model runs.
"""

import random

import numpy as np
import pytest

from ddpo_torch.data import bucket as t_bucket
from ddpo_torch.data import hdf5 as t_hdf5
from ddpo_torch.models.tokenizer import HashTokenizer as TorchTokenizer
from ddpo_torch.pipelines import sample as t_sample
from ddpo_torch.pipelines import save_sizes as t_sizes
from ddpo_torch.utils import fs
from ddpo_torch.utils import images as t_images
from ddpo_tpu.data import bucket as j_bucket
from ddpo_tpu.data import hdf5 as j_hdf5
from ddpo_tpu.models.tokenizer import HashTokenizer as JaxTokenizer
from ddpo_tpu.pipelines import save_sizes as j_sizes
from ddpo_tpu.utils import images as j_images

N, SPLIT = 5, 2  # three split files: 2 + 2 + 1 rows


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    prompts = [f"a photo of animal {i}" for i in range(N)]
    return {
        "inference_prompts": prompts,
        "training_prompts": [[p, p.upper()] for p in prompts],
        # smooth images, which JPEG keeps within 0.1
        "images": (0.5 + 0.4 * np.sin(np.linspace(0, 3, 24)[None, :, None, None]
                                      + rng.uniform(0, 6, (N, 1, 1, 3)))
                   * np.ones((N, 24, 24, 3))).astype(np.float32),
        "jpeg": rng.standard_normal((N, 1)),
        "vae": rng.standard_normal((N, 3, 3, 8)).astype(np.float32),
    }


def _write(package, path):
    """N rows through the package's RemoteWriter with the collection's schema."""
    if package == "port":
        writer = t_hdf5.RemoteWriter(str(path), split_size=SPLIT)
        t_sample.configure_writer(writer, ["jpeg", "vae"])
    else:
        writer = j_hdf5.RemoteWriter(str(path), split_size=SPLIT)
        writer.configure("images", encode_fn=j_images.encode_jpeg, decode_fn=j_images.decode_jpeg)
        writer.configure("inference_prompts")
        writer.configure("training_prompts", encode_fn=j_images.encode_generic,
                         decode_fn=j_images.decode_generic)
        for key in ("jpeg", "vae"):
            writer.configure(key)
    mask = np.ones(N, bool)
    assert writer.add_batch(_rows(), mask=mask) == N
    writer.close()


@pytest.fixture(params=["port", "jax"])
def written(request, tmp_path):
    """(writer's package, the dataset dir with its manifest)."""
    path = tmp_path / "samples"
    _write(request.param, path)
    manifest = (t_sizes if request.param == "port" else j_sizes).build_manifest(str(path))
    fs.save(str(path / "sizes.pkl"), manifest)
    return request.param, path


def test_files_cross_between_the_packages(written):
    writer, path = written
    reader = (j_hdf5 if writer == "port" else t_hdf5).RemoteReader(str(path))
    same = (t_hdf5 if writer == "port" else j_hdf5).RemoteReader(str(path))
    rows = _rows()
    assert len(reader) == N and sorted(reader.fields) == sorted(rows)
    if writer == "jax":  # the stored table names ddpo_tpu's codecs; the port reads its own
        assert reader.decode_fns["images"] is t_images.decode_jpeg
        assert reader.decode_fns["training_prompts"] is t_images.decode_generic
    for i in range(N):
        got, want = reader[i], same[i]
        assert set(got) == set(want)
        for key in got:
            if isinstance(want[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            else:
                assert got[key] == want[key], key
        # the manifest orders the split files by name: find the row written
        j = int(got["inference_prompts"].decode().split()[-1])
        assert got["inference_prompts"] == rows["inference_prompts"][j].encode()
        assert got["training_prompts"] == rows["training_prompts"][j]
        np.testing.assert_array_equal(got["vae"], rows["vae"][j])
        np.testing.assert_array_equal(got["jpeg"], rows["jpeg"][j])
        assert np.abs(got["images"] - rows["images"][j]).max() < 0.1  # JPEG at quality 95
    # the JPEG codec's bytes are the same in both packages
    j = int(reader.get(0, "inference_prompts").decode().split()[-1])
    raw = reader._get_file(0)["images"][0]
    np.testing.assert_array_equal(j_images.encode_jpeg(rows["images"][j]), raw)
    np.testing.assert_array_equal(t_images.encode_jpeg(rows["images"][j]), raw)


def test_sizes_manifests_are_equal(written, monkeypatch):
    _, path = written
    ours, theirs = t_sizes.build_manifest(str(path)), j_sizes.build_manifest(str(path))
    assert ours == theirs and sorted(ours.values()) == [1, 2, 2]
    assert all("-w0-" in name for name in ours)
    # main() writes what build_manifest gives, under the same name
    monkeypatch.chdir(path.parent)
    written_manifest = t_sizes.main(["--dataset", "debug-animals", "--loadpath", str(path)])
    assert written_manifest == ours == fs.unpickle(str(path / "sizes.pkl"))


def _collated(package, path, seed):
    if package == "port":
        dataset, loader = t_bucket.bucket_loader(t_hdf5.RemoteReader(str(path)),
                                                 TorchTokenizer(), batch_size=2)
    else:
        dataset, loader = j_bucket.get_bucket_loader(str(path), JaxTokenizer(), batch_size=2)
    dataset.make_weights("jpeg", 1 / 5.0, by_prompt=False)
    examples = []
    for i in range(len(dataset)):
        random.seed(seed + i)  # select_caption's draw
        examples.append(dataset[i])
    collate = t_bucket.collate_fn if package == "port" else j_bucket.collate_fn
    tokenizer = TorchTokenizer() if package == "port" else JaxTokenizer()
    return collate(tokenizer, examples), len(loader)


def test_collate_fn_batches_are_equal(written):
    _, path = written
    (ours, n_ours), (theirs, n_theirs) = (_collated(p, path, 3) for p in ("port", "jax"))
    assert n_ours == n_theirs == N // 2  # drop_last
    assert set(ours) == set(theirs) == {"vae", "input_ids", "idxs", "shuffled_idxs",
                                        "uncond_text", "jpeg", "weights"}
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    np.testing.assert_allclose(ours["weights"].mean(), 1.0, atol=1e-12)


def test_prefetch_loader_yields_the_collated_batches(written):
    _, path = written
    dataset, loader = t_bucket.bucket_loader(t_hdf5.RemoteReader(str(path)), TorchTokenizer(),
                                             batch_size=2, max_train_samples=4)
    batches = list(loader)
    assert len(dataset) == 4 and len(batches) == 2
    assert [list(b["idxs"]) for b in batches] == [[0, 1], [2, 3]]
    assert batches[0]["vae"].shape == (2, 3, 3, 8) and batches[0]["input_ids"].shape == (2, 77)
