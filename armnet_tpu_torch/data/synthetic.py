"""Synthetic libsvm dataset generator (copy of armnet_tpu/data/synthetic.py):
any geometry (Criteo: nfield 39, nfeat 2.1M; Avazu: 22 / 1.6M; MovieLens:
3 / 92k), with a planted learnable signal so that AUC rises above chance.
numpy only; for the same arguments it writes the same bytes as the JAX
package's generator.

    python -m armnet_tpu_torch.data.synthetic --out data/criteo_synth \
        --nfield 39 --nfeat 2100000 --rows 1000000 --val_rows 100000

Each field draws from its own id range (like real CTR vocabularies); the
label is a noisy logistic function of fixed per-field weights over the
drawn ids.
"""

import argparse
import os

import numpy as np

__all__ = ["generate_split", "generate_dataset", "make_arrays", "main"]


def make_arrays(rows, nfield, nfeat, seed=0, signal=2.0):
    """(ids [N, F] int32, values [N, F] f32, labels [N] f32)."""
    rng = np.random.RandomState(seed)
    per = nfeat // nfield
    base = (np.arange(nfield) * per).astype(np.int64)[None, :]
    ids = (rng.randint(0, per, (rows, nfield)) + base).astype(np.int32)
    values = np.ones((rows, nfield), np.float32)
    # planted signal: a fixed random weight per (field, id mod 64) bucket
    w = np.random.RandomState(1234).randn(nfield, 64).astype(np.float32)
    logit = signal * w[np.arange(nfield)[None, :], ids % 64].mean(1)
    p = 1.0 / (1.0 + np.exp(-logit))
    labels = (rng.rand(rows) < p).astype(np.float32)
    return ids, values, labels


def generate_split(path, rows, nfield, nfeat, seed=0, chunk=200_000):
    """Write one libsvm text file, `chunk` rows at a time (chunk i drawn
    with seed + i * chunk)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        done = 0
        while done < rows:
            n = min(chunk, rows - done)
            ids, _, labels = make_arrays(n, nfield, nfeat, seed=seed + done)
            lines = labels.astype(np.int64).astype("U1")
            for j in range(nfield):
                pair = np.char.add(ids[:, j].astype("U12"), ":1")
                lines = np.char.add(np.char.add(lines, " "), pair)
            f.write("\n".join(lines.tolist()) + "\n")
            done += n
    return path


def generate_dataset(out_dir, rows, val_rows, nfield, nfeat, seed=0):
    """Write train/valid/test.libsvm under out_dir (the tr*/va*/te* names
    the loaders glob)."""
    os.makedirs(out_dir, exist_ok=True)
    generate_split(os.path.join(out_dir, "train.libsvm"), rows, nfield, nfeat,
                   seed=seed)
    generate_split(os.path.join(out_dir, "valid.libsvm"), val_rows, nfield,
                   nfeat, seed=seed + 10_000_000)
    generate_split(os.path.join(out_dir, "test.libsvm"), val_rows, nfield,
                   nfeat, seed=seed + 20_000_000)
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic libsvm generator")
    p.add_argument("--out", required=True, help="output dataset directory")
    p.add_argument("--nfield", type=int, required=True)
    p.add_argument("--nfeat", type=int, required=True)
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--val_rows", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    generate_dataset(a.out, a.rows, a.val_rows, a.nfield, a.nfeat, a.seed)
    print(f"wrote {a.out}: train={a.rows} valid/test={a.val_rows} "
          f"(nfield={a.nfield}, nfeat={a.nfeat})")


if __name__ == "__main__":
    main()
