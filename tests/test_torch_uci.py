"""The UCI multi-class path and the synthetic generator of the port
(armnet_tpu_torch/data/{uci,synthetic}.py) against the JAX package's, on
the CPU. ARFF text and generated files go into tmp; nothing is downloaded.

  * load_arff, both split layouts (conxuntos.dat and _train/_test files),
    the Standardizer and every loader's batches equal to the JAX
    package's (bitwise: the same numpy ops), the valid_perc carve and the
    valid-aliases-train warning;
  * the CLI routes an *.arff folder to the multi-class head (a binary set
    too), sets nfield to the dataset's and keeps nfeat, honours
    --valid_perc, and the scalar-head models refuse it;
  * a 25-step multi-class trajectory of armnet on a seeded ARFF: the
    port's train step against the JAX one, the loss per step within 5e-4
    and the accuracy per step equal;
  * the synthetic generator writes the JAX generator's bytes.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.data import synthetic as jax_synthetic
from armnet_tpu.data import uci as jax_uci
from armnet_tpu.train.step import create_train_state as jax_train_state
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu.train.step import make_train_step as jax_make_train_step
from armnet_tpu_torch.data import synthetic, uci
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.checkpoint import load_checkpoint
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)
from test_torch_train import LR, NFEAT, init_pair, small_kw, to_jax

TOY_ARFF = """% comment line
@relation toy
@attribute f0 numeric
@attribute 'f1' numeric
@attribute f2 numeric
@attribute clase {0,1,2}
@data
1.0,2.0,3.0,0
4.0,5.0,6.0,1
7.0,8.0,9.0,2
1.5,2.5,3.5,0
4.5,5.5,6.5,1
7.5,8.5,9.5,2
2.0,3.0,4.0,0
5.0,6.0,7.0,1
"""


def write_arff(path, X, y, nclass):
    """A UCI-121 ARFF: numeric columns, then the nominal class."""
    with open(path, "w") as f:
        f.write(f"@relation {os.path.basename(path)[:-5]}\n")
        for j in range(X.shape[1]):
            f.write(f"@attribute f{j} numeric\n")
        f.write("@attribute clase {" + ",".join(map(str, range(nclass)))
                + "}\n@data\n")
        for row, label in zip(X, y):
            f.write(",".join(f"{v:.5f}" for v in row) + f",{label}\n")


def uci_folder(root, name, rows=200, nfield=5, nclass=4, seed=0,
               split="conxuntos"):
    """A seeded dataset folder with a class signal in the column means:
    {name}.arff + conxuntos.dat (the first 80% train), or
    {name}_train.arff / {name}_test.arff."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, nclass, rows)
    centers = rng.randn(nclass, nfield) * 1.5
    X = (centers[y] + rng.randn(rows, nfield)) * 3.0 + 10.0
    d = os.path.join(root, name)
    os.makedirs(d)
    cut = rows * 4 // 5
    if split == "conxuntos":
        write_arff(os.path.join(d, f"{name}.arff"), X, y, nclass)
        order = rng.permutation(rows)
        with open(os.path.join(d, "conxuntos.dat"), "w") as f:
            f.write(" ".join(map(str, order[:cut])) + "\n")
            f.write(" ".join(map(str, order[cut:])) + "\n")
    else:
        write_arff(os.path.join(d, f"{name}_train.arff"), X[:cut], y[:cut],
                   nclass)
        write_arff(os.path.join(d, f"{name}_test.arff"), X[cut:], y[cut:],
                   nclass)
    return d


def test_load_arff_matches_jax(tmp_path):
    path = tmp_path / "toy.arff"
    path.write_text(TOY_ARFF)
    X, y, nclass = uci.load_arff(str(path))
    Xj, yj, nj = jax_uci.load_arff(str(path))
    assert X.shape == (8, 3) and X.dtype == np.float32 and nclass == nj == 3
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(y, [0, 1, 2, 0, 1, 2, 0, 1])
    (tmp_path / "bad.arff").write_text("@relation x\n@attribute a numeric\n")
    with pytest.raises(ValueError, match="nominal class"):
        uci.load_arff(str(tmp_path / "bad.arff"))


@pytest.mark.parametrize("split", ["conxuntos", "files"])
def test_split_layouts_match_jax(tmp_path, split):
    d = uci_folder(str(tmp_path), "toy", rows=50, split=split)
    for train in (True, False):
        got = uci.load_uci_dataset(d, train=train)
        want = jax_uci.load_uci_dataset(d, train=train)
        assert got[0].shape == ((40, 5) if train else (10, 5))
        assert got[2] == want[2] == 4
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_overlapping_conxuntos_raises(tmp_path):
    d = uci_folder(str(tmp_path), "toy", rows=20)
    with open(os.path.join(d, "conxuntos.dat"), "w") as f:
        f.write("0 1 2 3\n3 4\n")
    with pytest.raises(ValueError, match="overlap"):
        uci.load_uci_dataset(d)


def test_standardizer_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(50, 4).astype(np.float32) * 3 + 1
    X[:, 2] = 7.0                  # a zero-variance column stays unscaled
    Z = uci.Standardizer(X)(X)
    np.testing.assert_array_equal(Z, jax_uci.Standardizer(X)(X))
    np.testing.assert_allclose(Z.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(Z.std(0)[[0, 1, 3]], 1.0, atol=1e-5)
    np.testing.assert_array_equal(Z[:, 2], 0.0)


def _batches(it, epochs=1):
    return [{k: np.asarray(v) for k, v in b.items()}
            for _ in range(epochs) for b in it]


@pytest.mark.parametrize("valid_perc", [0.0, 0.25])
def test_loaders_match_jax(tmp_path, valid_perc):
    """Every split's batches, two shuffled train epochs, equal the JAX
    loaders' bit for bit at seed 5; ids are the column index of every row
    (a broadcast view), the last batch is padded (id 0, value 1.0, mask
    0); the valid split is carved with RandomState(0), not the seed."""
    d = uci_folder(str(tmp_path), "toy", rows=90)
    kw = dict(batch_size=16, valid_perc=valid_perc, seed=5)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ports = uci.uci_loader(d, **kw)
        jaxs = jax_uci.uci_loader(d, **kw)
    aliased = [w for w in seen if "aliases the TRAIN" in str(w.message)]
    assert len(aliased) == (2 if valid_perc == 0 else 0)
    for p, j, epochs in zip(ports, jaxs, (2, 1, 1)):
        assert p.nclass == j.nclass == 4
        got, want = _batches(p, epochs), _batches(j, epochs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for k in ("id", "value", "y", "mask"):
                np.testing.assert_array_equal(a[k], b[k], k)
    train, valid, test = ports
    assert train.ds.ids.strides[0] == 0          # no [N, F] id matrix
    assert len(test.ds) == 18
    first = next(iter(test))
    np.testing.assert_array_equal(first["id"][3].numpy(), np.arange(5))
    last = _batches(test)[-1]
    assert last["mask"].sum() == 2 and (last["value"][2:] == 1.0).all()
    assert (last["id"][2:] == 0).all()
    if valid_perc == 0:
        assert valid.ds is train.ds and len(train.ds) == 72
    else:
        assert len(valid.ds) == 18 and len(train.ds) == 54
        again = uci.uci_loader(d, batch_size=16, valid_perc=0.25, seed=9)
        np.testing.assert_array_equal(again[1].ds.values, valid.ds.values)


def _cli(tmp_path, model, dataset, *flags):
    return cli.main(["--model", model, "--dataset", dataset, "--data_dir",
                     str(tmp_path / "data"), "--batch_size", "16",
                     "--nemb", "4", "--h", "4", "--nattn_head", "2",
                     "--mlp_nhid", "16", "--epoch", "2", "--patience", "2",
                     "--log_dir", str(tmp_path / "log"), "--ckpt_dir",
                     str(tmp_path / "ckpt"), "--exp_name", dataset,
                     "--seed", "3", "--device", "cpu", *flags])


def test_cli_trains_a_uci_folder(tmp_path):
    """An *.arff folder trains the multi-class head on the CPU: noutput
    becomes nclass, nfield the dataset's, nfeat stays the CLI's (the
    table keeps its rows); --valid_perc carves the valid split."""
    uci_folder(str(tmp_path / "data"), "toy", rows=120, nfield=6, nclass=3)
    res = _cli(tmp_path, "armnet", "toy", "--valid_perc", "0.2")
    assert [r[0] for r in res] == [3] and 0.0 < res[0][1] <= 1.0
    log = (tmp_path / "log" / "toy_3" / "stdout.log").read_text()
    assert "Acc" in log and "AUC" not in log
    with open(tmp_path / "log" / "toy_3" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["metric"] for r in rows] == ["Acc", "Acc"]
    meta = load_checkpoint(str(tmp_path / "ckpt" / "toy_3"))[1]["config"]
    assert (meta["noutput"], meta["nfield"], meta["nfeat"]) == (3, 6, 5500)


def test_cli_routes_a_binary_set_to_the_two_way_head(tmp_path):
    uci_folder(str(tmp_path / "data"), "toybin", rows=60, nfield=2,
               nclass=2)
    _cli(tmp_path, "dnn", "toybin", "--valid_perc", "0.25", "--nfeat", "1")
    log = (tmp_path / "log" / "toybin_3" / "stdout.log").read_text()
    assert "Acc" in log and "AUC" not in log
    meta = load_checkpoint(str(tmp_path / "ckpt" / "toybin_3"))[1]["config"]
    assert (meta["noutput"], meta["nfield"], meta["nfeat"]) == (2, 2, 2)


@pytest.mark.parametrize("model", ["fm", "cin"])
def test_cli_scalar_head_models_refuse_a_uci_set(tmp_path, model):
    uci_folder(str(tmp_path / "data"), "toy", rows=40)
    with pytest.raises(ValueError, match="scalar head"):
        _cli(tmp_path, model, "toy", "--valid_perc", "0.25")


def test_multiclass_trajectory_matches_jax(tmp_path):
    """armnet with a 4-way head on a seeded ARFF (5 fields, valid_perc
    0.2): 25 clamp+Adam steps of the port's train step (softmax CE,
    accuracy) against the JAX package's from the same weights, on the
    port loader's batches (the last of each epoch padded): the loss per
    step within 5e-4, as tests/test_torch_train.py holds armnet_1h's
    binary steps, and the accuracy per step equal."""
    d = uci_folder(str(tmp_path), "toy", rows=200)
    train, _, _ = uci.uci_loader(d, batch_size=24, valid_perc=0.2, seed=2)
    batches = _batches(train, epochs=5)[:25]
    assert len(batches) == 25 and batches[5]["mask"].sum() == 8
    kw = small_kw(model="armnet", h=5, nattn_head=3, alpha=1.7, noutput=4)
    jm, params, stats, model = init_pair(kw, seed=2)
    assert kw["nfeat"] == NFEAT and kw["nfield"] == train.ds.nfield

    state = jax_train_state(jm, to_jax(batches[0]), lr=LR).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    step = jax_make_train_step(task="multiclass")
    meters, key, lj, aj = jax_init_meters(), jax.random.key(0), [], []
    for b in batches:
        state, meters = step(state, meters, to_jax(b), key)
        lj.append(float(meters["loss_last"]))
        aj.append(float(meters["auc_last"]))

    tstate = create_train_state(model, LR)
    tstep = make_train_step(task="multiclass")
    tm, lt, at = init_meters("cpu"), [], []
    for b in batches:
        tm = tstep(tstate, tm, {k: torch.from_numpy(v) for k, v in b.items()})
        lt.append(float(tm["loss_last"]))
        at.append(float(tm["auc_last"]))
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, atol=5e-4)
    np.testing.assert_allclose(at, aj, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_files_are_the_jax_generators_bytes(tmp_path, seed):
    """generate_dataset writes the JAX generator's bytes, chunked or not."""
    for name, mod in (("port", synthetic), ("jax", jax_synthetic)):
        mod.generate_dataset(str(tmp_path / name), rows=301, val_rows=57,
                             nfield=7, nfeat=700, seed=seed)
        mod.generate_split(str(tmp_path / name / "chunked.libsvm"), 250, 3,
                           90, seed=seed, chunk=100)
    for f in ("train", "valid", "test", "chunked"):
        got = (tmp_path / "port" / f"{f}.libsvm").read_bytes()
        assert got == (tmp_path / "jax" / f"{f}.libsvm").read_bytes(), f
    ids, values, labels = synthetic.make_arrays(64, 7, 700, seed=seed)
    for a, b in zip((ids, values, labels),
                    jax_synthetic.make_arrays(64, 7, 700, seed=seed)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_cli_round_trip(tmp_path, capsys):
    """python -m armnet_tpu_torch.data.synthetic writes a split the port's
    loaders read back: 39 fields per row, ids in each field's range."""
    from armnet_tpu_torch.data.libsvm import make_dataloaders

    out = tmp_path / "synth"
    synthetic.main(["--out", str(out), "--nfield", "39", "--nfeat", "3900",
                    "--rows", "200", "--val_rows", "50", "--seed", "1"])
    assert "wrote" in capsys.readouterr().out
    tr, va, te = make_dataloaders("synth", str(tmp_path), 39, 64)
    assert (len(tr.ds), len(va.ds), len(te.ds)) == (200, 50, 50)
    per = 3900 // 39
    assert ((tr.ds.ids // per) == np.arange(39)).all()
    assert set(np.unique(tr.ds.labels)) <= {0.0, 1.0}
