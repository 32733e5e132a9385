"""Word2Vec: skip-gram embeddings trained on the card (PyTorch + CUDA).

Port of ``albedo_tpu/models/word2vec.py``. Reference parity:
``Word2VecCorpusBuilder.scala:74-83`` — vectorSize=200, windowSize=5,
minCount=10, maxIter=30 over the user+repo text corpus, and
``Word2VecModel.transform`` averaging word vectors per document as the
text-column featurizer (``LogisticRegressionRanker.scala:210-215``).

Skip-gram with negative sampling, as the JAX module: the vocabulary, the
subsampling and the (center, context) pairs are built on the host with
``np.random.default_rng(seed)`` and are byte-identical to the JAX module's.
The device half runs the K9 kernel (``ops/sgns.py sgns_step``), or with
``shared_negatives = K > 0`` the K9s kernel (``sgns_shared_step``: one (K,)
pool of negatives per minibatch, the negative term a (B, K) logits GEMM
scaled by ``negatives / K``), and the dense Adam kernel (``adam_dense``,
over both tables at once) once per minibatch. Device randomness — the
uniform(±0.5/dim) init of the input table, the per-epoch permutation (the
remainder of the last minibatch is dropped) and the negatives, drawn by
inverse CDF over the float32 cumulative unigram^0.75 table — comes from one
``torch.Generator`` on the fit's device seeded with ``seed``, so it cannot
reproduce ``jax.random``'s draws: seeded fits are compared by metric.

Not ported: ``mesh`` (raises ``NotImplementedError``), and the persistent
executable cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import pandas as pd
import torch

from albedo_tpu_torch.datasets.ragged import segment_positions
from albedo_tpu_torch.features.pipeline import Transformer, memo_map
from albedo_tpu_torch.ops.sgns import adam_dense, sgns_shared_step, sgns_shared_workspace, sgns_step
from albedo_tpu_torch.utils.device import resolve_device


def skipgram_pairs(
    ids: np.ndarray, lengths: np.ndarray, b: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized skip-gram (center, context) pair construction.

    ``ids``: all sentences' token ids concatenated, shape (T,).
    ``lengths``: tokens per sentence, sum = T.
    ``b``: per-position dynamic window radius (word2vec's b ~ uniform[1, w]).

    Emits exactly the pairs of the per-position loop — for every position i,
    every j in [i-b_i, i+b_i] within the same sentence, j != i — offset-major,
    in the JAX module's order."""
    ids = np.asarray(ids, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int64)
    b = np.asarray(b)
    if ids.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    pos = segment_positions(lengths)
    slen = np.repeat(lengths, lengths)
    max_b = int(b.max()) if b.size else 0
    centers_parts, contexts_parts = [], []
    for d in range(-max_b, max_b + 1):
        if d == 0:
            continue
        mask = (abs(d) <= b) & (pos + d >= 0) & (pos + d < slen)
        idx = np.nonzero(mask)[0]
        centers_parts.append(ids[idx])
        contexts_parts.append(ids[idx + d])
    return (
        np.concatenate(centers_parts) if centers_parts else np.zeros(0, np.int32),
        np.concatenate(contexts_parts) if contexts_parts else np.zeros(0, np.int32),
    )


@dataclasses.dataclass
class Word2VecModel(Transformer):
    """Fitted embeddings + the document-averaging transformer (host numpy)."""

    vocab: list[str]
    vectors: np.ndarray  # (V, dim) float32
    input_col: str = "words"
    output_col: str = "words__w2v"

    def __post_init__(self):
        self._index = {w: i for i, w in enumerate(self.vocab)}

    @staticmethod
    def from_arrays(arrays: dict[str, np.ndarray], input_col: str = "words",
                    output_col: str = "words__w2v") -> "Word2VecModel":
        """A model from ``to_arrays()`` output (the port's or the JAX
        model's): vocab and vectors."""
        return Word2VecModel(
            vocab=[str(w) for w in arrays["vocab"]],
            vectors=np.asarray(arrays["vectors"], np.float32),
            input_col=input_col, output_col=output_col,
        )

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def vector(self, word: str) -> np.ndarray | None:
        i = self._index.get(word)
        return None if i is None else self.vectors[i]

    def document_vector(self, words: list[str]) -> np.ndarray:
        """Mean of in-vocab word vectors (zero vector if none)."""
        idx = [self._index[w] for w in words if w in self._index]
        if not idx:
            return np.zeros(self.dim, dtype=np.float32)
        return self.vectors[idx].mean(axis=0)

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        out = df.copy()
        out[self.output_col] = memo_map(df[self.input_col], self.document_vector, key=tuple)
        return out

    def find_synonyms(self, word: str, k: int = 10) -> list[tuple[str, float]]:
        """Cosine-similarity nearest words (Spark ``findSynonyms`` parity)."""
        v = self.vector(word)
        if v is None:
            return []
        norms = np.linalg.norm(self.vectors, axis=1) + 1e-9
        sims = self.vectors @ v / (norms * (np.linalg.norm(v) + 1e-9))
        order = np.argsort(-sims)
        return [(self.vocab[i], float(sims[i])) for i in order if self.vocab[i] != word][:k]

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {"vectors": self.vectors, "vocab": np.asarray(self.vocab, dtype=object)}


@dataclasses.dataclass
class CorpusPlan:
    """The host half of a fit: vocab, unigram counts and skip-gram pairs."""

    vocab: list[str]
    freq: np.ndarray      # (V,) float64 corpus counts, vocab order
    centers: np.ndarray   # (P,) int32
    contexts: np.ndarray  # (P,) int32


@dataclasses.dataclass
class Word2Vec:
    """Skip-gram negative-sampling estimator. Defaults mirror the reference
    corpus builder (``Word2VecCorpusBuilder.scala:74-83``)."""

    dim: int = 200
    window: int = 5
    min_count: int = 10
    max_iter: int = 30
    negatives: int = 5
    shared_negatives: int = 0
    batch_size: int = 4096
    learning_rate: float = 0.025
    subsample: float = 1e-3
    seed: int = 42
    input_col: str = "words"
    output_col: str | None = None
    mesh: Any | None = None
    device: str | torch.device = "cuda"

    def plan(self, sentences: list[list[str]]) -> CorpusPlan:
        """Vocab (order: -count, word), subsampling and pairs, on the host
        under ``default_rng(seed)`` — the JAX module's code."""
        rng = np.random.default_rng(self.seed)
        flat = [w for s in sentences for w in s]
        lengths = np.fromiter((len(s) for s in sentences), dtype=np.int64, count=len(sentences))
        if flat:
            codes, uniques = pd.factorize(np.asarray(flat, dtype=object), sort=False)
            uniq_counts = np.bincount(codes, minlength=len(uniques))
        else:
            codes = np.zeros(0, np.int64)
            uniques, uniq_counts = np.asarray([], dtype=object), np.zeros(0, np.int64)
        keep = uniq_counts >= self.min_count
        order = np.asarray(
            sorted(np.nonzero(keep)[0], key=lambda i: (-uniq_counts[i], uniques[i])),
            dtype=np.int64,
        )
        vocab = [str(w) for w in uniques[order]]
        v_size = len(vocab)
        if v_size == 0:
            empty = np.zeros(0, np.int32)
            return CorpusPlan(vocab, np.zeros(0), empty, empty)
        code_to_vocab = np.full(len(uniques), -1, dtype=np.int64)
        code_to_vocab[order] = np.arange(v_size)
        token_ids = code_to_vocab[codes]
        freq = uniq_counts[order].astype(np.float64)
        total = freq.sum()
        if self.subsample > 0:
            f = freq / total
            keep_p = np.minimum(1.0, np.sqrt(self.subsample / f) + self.subsample / f)
        else:
            keep_p = np.ones(v_size)
        sent_id = np.repeat(np.arange(len(sentences), dtype=np.int64), lengths)
        mask = token_ids >= 0
        if self.subsample > 0:
            mask &= rng.random(token_ids.size) < keep_p[np.maximum(token_ids, 0)]
        ids_concat = token_ids[mask].astype(np.int32)
        kept_lengths = np.bincount(sent_id[mask], minlength=len(sentences))
        b = rng.integers(1, self.window + 1, size=ids_concat.size)
        centers, contexts = skipgram_pairs(ids_concat, kept_lengths, b)
        return CorpusPlan(vocab, freq, centers, contexts)

    def fit_corpus(self, sentences: list[list[str]]) -> Word2VecModel:
        if self.mesh is not None:
            raise NotImplementedError("Word2Vec(mesh=...): the data-parallel fit is not ported yet")
        dev = resolve_device(self.device)
        out_col = self.output_col or f"{self.input_col}__w2v"
        plan = self.plan(sentences)
        v_size = len(plan.vocab)
        if v_size == 0 or plan.centers.size == 0:
            return Word2VecModel(plan.vocab, np.zeros((v_size, self.dim), np.float32), self.input_col, out_col)
        state, self.last_fit_report = self.train(plan, dev)
        vectors = state["tables"][0].cpu().numpy().astype(np.float32)
        return Word2VecModel(plan.vocab, vectors, self.input_col, out_col)

    def train(self, plan: CorpusPlan, dev: torch.device) -> tuple[dict, dict]:
        """The device loop: ``max_iter`` epochs of shuffled minibatches, each
        one K9 step (K9s with a shared pool) and one dense Adam step. The
        shared pool is drawn once per step, ``(K,)`` uniforms through the
        inverse CDF, as the JAX step draws it. The "in" and "out" tables are
        one (2, V, dim) tensor, as are their gradients and moments, so one
        Adam launch updates both. Returns the final optimizer state
        (``tables``, ``moments`` (m, v) and step ``count``, on the device)
        and a report (pairs, batch, steps, per-epoch mean loss)."""
        v_size, dim = len(plan.vocab), self.dim
        p_noise = plan.freq**0.75
        p_noise /= p_noise.sum()
        noise_cdf = torch.as_tensor(np.cumsum(p_noise), dtype=torch.float32).to(dev)
        centers = torch.as_tensor(plan.centers.astype(np.int32)).to(dev)
        contexts = torch.as_tensor(plan.contexts.astype(np.int32)).to(dev)
        n_pairs = int(centers.shape[0])
        bs = min(self.batch_size, n_pairs)
        steps = n_pairs // bs

        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        scale = 0.5 / dim
        tables = torch.zeros((2, v_size, dim), dtype=torch.float32, device=dev)  # in, out
        tables[0].uniform_(-scale, scale, generator=gen)
        grads = torch.zeros_like(tables)
        moments = (torch.zeros_like(tables), torch.zeros_like(tables))
        loss_acc = torch.zeros(1, dtype=torch.float32, device=dev)
        shared = self.shared_negatives
        neg_shape = (shared,) if shared else (bs, self.negatives)
        # K9s's workspace (logit gradients, pair rows, partials), allocated once.
        workspace = sgns_shared_workspace(bs, dim, shared, dev) if shared else None
        count = 0
        epoch_loss = []
        for _ in range(self.max_iter):
            perm = torch.randperm(n_pairs, generator=gen, device=dev)[: steps * bs]
            c_sh = centers[perm].view(steps, bs)
            o_sh = contexts[perm].view(steps, bs)
            loss_acc.zero_()
            for s in range(steps):
                u = torch.rand(neg_shape, generator=gen, device=dev)
                neg = torch.searchsorted(noise_cdf, u).clamp_max_(v_size - 1).to(torch.int32)
                if shared:
                    sgns_shared_step(tables[0], tables[1], c_sh[s], o_sh[s], neg, grads[0], grads[1], loss_acc,
                                     self.negatives / shared, workspace)
                else:
                    sgns_step(tables[0], tables[1], c_sh[s], o_sh[s], neg, grads[0], grads[1], loss_acc)
                count += 1
                adam_dense(tables, grads, *moments, count, self.learning_rate)
            epoch_loss.append(loss_acc / steps)
        report = {
            "pairs": n_pairs, "batch": bs, "steps": count,
            "epoch_loss": [float(x) for x in torch.cat(epoch_loss).cpu()],
        }
        return {"tables": tables, "moments": moments, "count": count, "noise_cdf": noise_cdf}, report

    def fit(self, df: pd.DataFrame) -> Word2VecModel:
        return self.fit_corpus(list(df[self.input_col]))
