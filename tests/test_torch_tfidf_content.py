"""K14 in the port against the JAX package on the CPU: the tf-idf index and
its similarity queries, and the Word2Vec content backend, through K5 at the
rows' width (the kernel's wide path on the card).

Inputs: ``synthetic_tables(400, 300, mean_stars=20, seed=42)`` built by each
package (byte-equal, ``tests/test_torch_datasets.py``); the content backend
runs on Word2Vec vectors shared by both packages (numpy, ``default_rng(1)``).

- The host fit (vocabulary, idf, the normalized matrix) is byte-equal.
- Query results are compared with the near-tie rule: scores of the items
  both packages return within rtol 1e-5, atol 1e-6 (K5's plain version sums
  the products in index order, JAX's matvec and ``topk_scores`` in XLA's),
  and an item returned by only one of them within that tolerance of the
  lowest score the JAX package kept.
"""

import numpy as np
import pytest

from albedo_tpu.datasets import synthetic_tables as jax_tables
from albedo_tpu.models.word2vec import Word2VecModel as JaxW2V
from albedo_tpu.recommenders import base as jax_base
from albedo_tpu.recommenders import content as jax_content
from albedo_tpu.recommenders import tfidf as jax_tfidf
from albedo_tpu_torch.datasets import synthetic_tables
from albedo_tpu_torch.models.word2vec import Word2VecModel
from albedo_tpu_torch.recommenders import base, content, tfidf

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def assert_same_list(got: dict, want: dict) -> None:
    """``got``/``want``: id -> score of one query's results."""
    assert len(got) == len(want)
    for i in got.keys() & want.keys():
        assert _close(got[i], want[i]), (i, got[i], want[i])
    if want:
        floor = min(want.values())
        for i in got.keys() ^ want.keys():
            assert _close(got.get(i, want.get(i)), floor), (i, floor)


@pytest.fixture(scope="module")
def world():
    t = synthetic_tables(n_users=400, n_items=300, mean_stars=20, seed=42)
    jt = jax_tables(n_users=400, n_items=300, mean_stars=20, seed=42)
    search = tfidf.TfidfSimilaritySearch(min_df=2, device="cpu").fit(t.repo_info)
    jsearch = jax_tfidf.TfidfSimilaritySearch(min_df=2).fit(jt.repo_info)
    return t, jt, search, jsearch


def test_host_fit_is_byte_equal(world):
    _, _, search, jsearch = world
    assert search.vocab == jsearch.vocab
    assert search.idf.tobytes() == jsearch.idf.tobytes()
    assert search.matrix.dtype == np.float32
    assert search.matrix.tobytes() == jsearch.matrix.tobytes()
    np.testing.assert_array_equal(search.doc_ids, jsearch.doc_ids)
    assert search.matrix.shape[1] > 64  # the rows are wider than K5's narrow path


def test_similar_matches_jax(world):
    t, _, search, jsearch = world
    names = t.repo_info.sort_values("repo_stargazers_count", ascending=False)["repo_full_name"]
    for name in list(names[:8]) + ["no/such-repo"]:
        got = search.similar(name, k=10)
        want = jsearch.similar(name, k=10)
        assert_same_list({n: s for s, n in got}, {n: s for s, n in want})
        assert name not in {n for _, n in got}


def _queries(t, n=40, seed=0):
    rng = np.random.default_rng(seed)
    ids = t.repo_info["repo_id"].to_numpy(np.int64)
    queries = [rng.choice(ids, size=int(rng.integers(1, 6)), replace=False) for _ in range(n)]
    queries[3] = np.array([10**12], np.int64)          # no known item: no candidates
    queries[5] = np.zeros(0, np.int64)                 # an empty query
    return queries


def test_similar_to_repos_matches_jax(world):
    t, _, search, jsearch = world
    queries = _queries(t)
    got = search.similar_to_repos(queries, 20)
    want = jsearch.similar_to_repos(queries, 20)
    for q, (g, w) in enumerate(zip(got, want)):
        assert_same_list(dict(zip(g[0].tolist(), g[1])), dict(zip(w[0].tolist(), w[1])))
        assert not set(g[0].tolist()) & set(queries[q].tolist())  # query rows excluded
    assert got[3][0].size == 0 and got[5][0].size == 0


def _shared_w2v(t, dim):
    """Numpy vectors over the repo text's words, one model per package."""
    from albedo_tpu_torch.features.text import Tokenizer

    tok = Tokenizer("_", remove_stop_words=True)
    text = (t.repo_info["repo_description"].fillna("") + " " + t.repo_info["repo_name"].fillna(""))
    vocab = sorted({w for s in text for w in tok.tokenize(s)})
    vectors = np.random.default_rng(1).normal(scale=0.3, size=(len(vocab), dim)).astype(np.float32)
    return Word2VecModel(vocab=vocab, vectors=vectors), JaxW2V(vocab=vocab, vectors=vectors)


@pytest.mark.parametrize("dim", [16, 200])
def test_more_like_this_matches_jax(world, dim):
    t, jt, _, _ = world
    w2v, jw2v = _shared_w2v(t, dim)
    backend = content.EmbeddingSearchBackend(t.repo_info, w2v, device="cpu")
    jbackend = jax_content.EmbeddingSearchBackend(jt.repo_info, jw2v)
    assert backend.vectors.tobytes() == jbackend.vectors.tobytes()
    queries = _queries(t, seed=dim)
    for (gi, gs), (wi, ws) in zip(backend.more_like_this(queries, 30), jbackend.more_like_this(queries, 30)):
        assert_same_list(dict(zip(gi.tolist(), gs)), dict(zip(wi.tolist(), ws)))


def _frame_lists(df):
    out = {}
    for u, i, s in zip(df["user_id"], df["repo_id"], df["score"]):
        out.setdefault(int(u), {})[int(i)] = float(s)
    return out


@pytest.mark.parametrize("source", ["tfidf", "content"])
def test_recommenders_match_jax(world, source):
    t, jt, search, jsearch = world
    users = t.user_info["user_id"].to_numpy(np.int64)[:60]
    if source == "tfidf":
        rec = tfidf.TfidfRecommender(search, t.starring, top_k=15)
        jrec = jax_tfidf.TfidfRecommender(jsearch, jt.starring, top_k=15)
    else:
        w2v, jw2v = _shared_w2v(t, 200)
        rec = content.ContentRecommender(content.EmbeddingSearchBackend(t.repo_info, w2v, device="cpu"),
                                         t.starring, top_k=15, enable_evaluation_mode=True)
        jrec = jax_content.ContentRecommender(jax_content.EmbeddingSearchBackend(jt.repo_info, jw2v),
                                              jt.starring, top_k=15, enable_evaluation_mode=True)
    got, want = _frame_lists(rec.recommend_for_users(users)), _frame_lists(jrec.recommend_for_users(users))
    assert got.keys() == want.keys() and len(want) > 30
    for u in want:
        assert_same_list(got[u], want[u])


@pytest.mark.parametrize("offset", [0, 30])
def test_recent_starred_provider_matches_jax(world, offset):
    t, jt, _, _ = world
    mine = base.recent_starred_provider(t.starring, top_k=30, offset=offset)
    ref = jax_base.recent_starred_provider(jt.starring, top_k=30, offset=offset)
    for u in list(t.user_info["user_id"][:50]) + [10**12]:
        np.testing.assert_array_equal(mine(int(u)), ref(int(u)))


def test_analyze_matches_jax():
    text = "Fast JSON parsing: parsers, parsed streams and the streaming of JSON for Rust"
    assert tfidf._analyze(text, (1, 2)) == jax_tfidf._analyze(text, (1, 2))
    assert tfidf._analyze(text, (1, 1)) == jax_tfidf._analyze(text, (1, 1))
