"""The port's predict entry point on the CPU: scores of a bridged JAX
armnet_1h checkpoint against the JAX model's own probabilities, the summary
AUC against sklearn's, and the device/numerics rules of the slice. Also the
libsvm loader, the checkpoint layout and the metrics it relies on."""

import json
import os

import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from armnet_tpu_torch import predict, resolve_device
from armnet_tpu_torch.data.libsvm import BatchIterator, LibsvmDataset
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from armnet_tpu_torch.train.metrics import masked_accuracy, masked_roc_auc
from test_torch_armnet1h import (NFIELD, jax_armnet1h, jax_logits,
                                 port_model, random_batch, small_config)

NROWS, BATCH = 50, 16          # 50 = 3 * 16 + 2: a partial last batch


def _write_libsvm(path, batch, labels):
    with open(path, "w") as f:
        for ids, vals, y in zip(batch["id"], batch["value"], labels):
            f.write(f"{int(y)} " + " ".join(
                f"{i}:{v:.6g}" for i, v in zip(ids, vals)) + "\n")


@pytest.fixture(params=[1, 3], ids=["binary", "3class"])
def served(request, tmp_path):
    """A 50-row libsvm file, a port checkpoint bridged from a JAX init, and
    the JAX model's logits on the rows as written."""
    noutput = request.param
    kw = small_config(h=6, alpha=1.7, ensemble=True, noutput=noutput)
    jm, v, flat = jax_armnet1h(kw, seed=5)
    rng = np.random.RandomState(6)
    batch = random_batch(rng, NROWS, kw["nfeat"])
    labels = rng.randint(0, max(2, noutput), NROWS)
    inp = str(tmp_path / "rows.libsvm")
    _write_libsvm(inp, batch, labels)
    ds = LibsvmDataset(inp, NFIELD)            # the values as parsed back
    logits = jax_logits(jm, v, {"id": ds.ids, "value": ds.values})
    cfg = ModelConfig(**kw)
    root = str(tmp_path / "ckpt")
    save_checkpoint(port_model(flat, kw), cfg, root, "best")
    return {"inp": inp, "root": root, "logits": logits, "labels": labels,
            "noutput": noutput, "tmp": tmp_path}


def _argv(served, *extra):
    return ["--device", "cpu", "--ckpt", served["root"], "--input",
            served["inp"], "--batch_size", str(BATCH), *extra]


def test_scores_match_jax_model(served, capsys):
    out = str(served["tmp"] / "rows.scores")
    summary = predict.main(_argv(served, "--output", out))
    scores = np.loadtxt(out, ndmin=2)
    lg = served["logits"]
    if served["noutput"] == 1:
        want = 1.0 / (1.0 + np.exp(-lg))
        np.testing.assert_allclose(scores[:, 0], want, atol=1e-5)
        assert summary["auc"] == pytest.approx(
            roc_auc_score(served["labels"], lg), abs=1e-6)
    else:
        e = np.exp(lg - lg.max(-1, keepdims=True))
        np.testing.assert_allclose(scores, e / e.sum(-1, keepdims=True),
                                   atol=1e-5)
        assert summary["accuracy"] == pytest.approx(
            np.mean(lg.argmax(-1) == served["labels"]), abs=1e-6)
    assert summary["rows"] == NROWS and summary["batches"] == 4
    assert json.loads(capsys.readouterr().out.strip()) == summary


def test_stdout_output_and_tag_dir_spelling(served, capsys):
    summary = predict.main(["--device", "cpu", "--ckpt",
                            os.path.join(served["root"], "best"), "--input",
                            served["inp"], "--batch_size", str(BATCH),
                            "--output", "-"])
    cap = capsys.readouterr()
    assert len(cap.out.strip().splitlines()) == NROWS
    assert json.loads(cap.err.strip()) == summary
    assert summary["tag"] == "best"


def test_device_defaults_to_cuda_and_never_falls_back(served):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict.main(["--ckpt", served["root"], "--input", served["inp"]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("case", ["bf16", "xla", "pallas", "pallas-fused"])
def test_bf16_and_pallas_kernels_raise(served, case):
    """A sidecar's "kernels": "xla" still raises; --bf16 scores in
    bfloat16, within a bfloat16 tolerance (2e-2, five ulps) of the float32
    JAX model's probabilities; a sidecar's "pallas" (the per-op kernels)
    and "pallas-fused" (the fused ARM-1h kernels) score with the JAX
    model's probabilities."""
    if case == "bf16":
        out = str(served["tmp"] / "bf16.scores")
        summary = predict.main(_argv(served, "--bf16", "--output", out))
        assert summary["rows"] == NROWS
        lg = served["logits"]
        if served["noutput"] == 1:
            want = 1.0 / (1.0 + np.exp(-lg))
        else:
            e = np.exp(lg - lg.max(-1, keepdims=True))
            want = e / e.sum(-1, keepdims=True)
        got = np.loadtxt(out, ndmin=2).reshape(want.shape)
        np.testing.assert_allclose(got, want, atol=2e-2)
        return
    meta_path = os.path.join(served["root"], "best.meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["config"]["kernels"] = case
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    if case == "xla":
        with pytest.raises(NotImplementedError, match="xla"):
            predict.main(_argv(served))
        return
    out = str(served["tmp"] / f"{case}.scores")
    summary = predict.main(_argv(served, "--output", out))
    assert summary["rows"] == NROWS
    lg = served["logits"]
    if served["noutput"] == 1:
        want = 1.0 / (1.0 + np.exp(-lg))
    else:
        e = np.exp(lg - lg.max(-1, keepdims=True))
        want = e / e.sum(-1, keepdims=True)
    np.testing.assert_allclose(np.loadtxt(out, ndmin=2).reshape(want.shape),
                               want, atol=1e-5)


def test_checkpoint_round_trip(tmp_path):
    cfg = ModelConfig(**small_config())
    model = port_model(jax_armnet1h(small_config())[2], small_config())
    save_checkpoint(model, cfg, str(tmp_path), "last")
    state, meta = load_checkpoint(str(tmp_path / "last"))
    assert meta["config"]["nfeat"] == cfg.nfeat
    for k, t in model.state_dict().items():
        torch.testing.assert_close(state[k], t)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), "best")


def test_batches_pad_with_value_one_and_mask_zero(tmp_path):
    path = str(tmp_path / "d.libsvm")
    rng = np.random.RandomState(0)
    batch = random_batch(rng, 5, 100)
    _write_libsvm(path, batch, [1, 0, 1, 0, 1])
    ds = LibsvmDataset(path, NFIELD)
    np.testing.assert_array_equal(ds.ids, batch["id"])
    last = list(BatchIterator(ds, 4))[-1]
    assert last["mask"].tolist() == [1.0, 0.0, 0.0, 0.0]
    assert (last["id"][1:] == 0).all() and (last["value"][1:] == 1.0).all()


def test_malformed_lines_are_skipped(tmp_path):
    """The native parser skips the malformed line and warns with the count
    (the line-by-line parser's own print is held in
    test_torch_data_path.py)."""
    path = str(tmp_path / "bad.libsvm")
    with open(path, "w") as f:
        f.write("1 1:1 2:1\n0 3:1\n0 4:0.5 5:1\n")
    with pytest.warns(UserWarning, match="skipped 1 malformed line"):
        ds = LibsvmDataset(path, 2, use_cache=False)
    assert len(ds) == 2 and ds.ids.tolist() == [[1, 2], [4, 5]]
    assert ds.route == "native"


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_auc_matches_sklearn_with_ties_and_pads(seed):
    rng = np.random.RandomState(seed)
    logits = np.round(rng.randn(40), 1).astype(np.float32)   # many ties
    labels = rng.randint(0, 2, 40).astype(np.float32)
    mask = np.ones(40, np.float32)
    mask[-7:] = 0
    auc = masked_roc_auc(*map(torch.from_numpy, (logits, labels, mask)))
    assert float(auc) == pytest.approx(
        roc_auc_score(labels[:-7], logits[:-7]), abs=1e-6)


def test_masked_auc_single_class_and_accuracy():
    ones = torch.ones(6)
    assert float(masked_roc_auc(torch.randn(6), ones, ones)) == 0.0
    logits = torch.tensor([[2.0, 1.0], [0.0, 3.0], [1.0, 0.0]])
    acc = masked_accuracy(logits, torch.tensor([0.0, 0.0, 1.0]),
                          torch.tensor([1.0, 1.0, 0.0]))
    assert float(acc) == pytest.approx(0.5)
