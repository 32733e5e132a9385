"""The port's retrieval bank (K7, single device) against the JAX package's
bank on the CPU, and against the port's own host score paths.

Both banks register the same four sources over the same tables: ``als``
(user rows, seen items excluded through the serving exclusion table),
``content`` (item mean over L2-normalized document vectors), ``tfidf`` (item
mean over the tf-idf projection, fitted by each package: their fits are
byte-equal) and ``user_sim`` (the user table scored against itself).
Tolerances: item lists equal up to near-ties and scores within 1e-5 of the
largest score (``retrieval.parity.candidate_parity``), as the JAX package
holds its own bank against its host paths: XLA's dot and norm and the port's
ordered sums round differently. Calibration is host numpy in both: equal to
1e-6 relative.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.datasets import synthetic_tables as j_tables
from albedo_tpu.models.als import ALSModel as JaxModel
from albedo_tpu.recommenders import TfidfSimilaritySearch as JaxTfidf
from albedo_tpu.recommenders.base import recent_starred_provider as j_provider
from albedo_tpu.retrieval.bank import BankSourceSpec as JaxSpec
from albedo_tpu.retrieval.bank import RetrievalBank as JaxBank
from albedo_tpu.retrieval.bank import _make_query_program
from albedo_tpu_torch.datasets import synthetic_tables
from albedo_tpu_torch.datasets.ragged import padded_rows
from albedo_tpu_torch.models.als import ALSModel
from albedo_tpu_torch.ops.topk import bank_query, bank_query_reference, mean_query_reference
from albedo_tpu_torch.recommenders import (
    ALSRecommender,
    ContentRecommender,
    EmbeddingSearchBackend,
    TfidfRecommender,
    TfidfSimilaritySearch,
    recent_starred_provider,
)
from albedo_tpu_torch.retrieval import (
    BankSourceSpec,
    RetrievalBank,
    build_default_bank,
    candidate_parity,
    mean_query_vectors,
)
from albedo_tpu_torch.utils import events, faults

K = 12
RANK = 8
TOL = 1e-5
SOURCES = ("als", "content", "tfidf", "user_sim")


class _W2VStub:
    """Deterministic Word2Vec stand-in: each word hashes to a fixed unit
    vector (the content backend only needs ``document_vector``)."""

    dim = 12

    def document_vector(self, words):
        if not words:
            return np.zeros(self.dim, dtype=np.float32)
        rows = [np.random.default_rng(zlib.crc32(w.encode())).normal(size=self.dim) for w in words]
        v = np.mean(rows, axis=0)
        return (v / max(np.linalg.norm(v), 1e-9)).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_faults():
    faults.reset()
    events.reset_global_metrics()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def world():
    tables = synthetic_tables(n_users=150, n_items=110, mean_stars=8, seed=3)
    matrix = tables.star_matrix(policy="off")
    rng = np.random.default_rng(9)
    uf = (rng.standard_normal((matrix.n_users, RANK)) / np.sqrt(RANK)).astype(np.float32)
    vf = (rng.standard_normal((matrix.n_items, RANK)) / np.sqrt(RANK)).astype(np.float32)
    model = ALSModel.from_arrays({"user_factors": uf, "item_factors": vf, "rank": RANK}, device="cpu")
    backend = EmbeddingSearchBackend(tables.repo_info, _W2VStub(), device="cpu")
    search = TfidfSimilaritySearch(min_df=1, device="cpu").fit(tables.repo_info)
    indptr, cols, _ = matrix.csr()
    excl = padded_rows(indptr, cols, np.arange(matrix.n_users))
    j = j_tables(n_users=150, n_items=110, mean_stars=8, seed=3)
    j_search = JaxTfidf(min_df=1).fit(j.repo_info)
    np.testing.assert_array_equal(j_search.matrix, search.matrix)
    return dict(tables=tables, matrix=matrix, model=model, backend=backend, search=search, excl=excl,
                j_tables=j, j_matrix=j.star_matrix(policy="off"), j_model=JaxModel(uf, vf, RANK),
                j_search=j_search)


def _port_specs(w):
    provider = recent_starred_provider(w["tables"].starring, top_k=K)
    uf = w["model"].user_factors
    return [
        ALSRecommender(w["model"], w["matrix"], exclude_seen=True).bank_registration(),
        BankSourceSpec(name="content", kind="item_mean", vectors=w["backend"].vectors,
                       item_ids=w["backend"].item_ids, query_items=provider),
        w["search"].bank_registration(query_items=provider),
        BankSourceSpec(name="user_sim", kind="user_rows", vectors=uf, item_ids=w["matrix"].user_ids,
                       user_vectors=uf),
    ]


def _jax_specs(w):
    provider = j_provider(w["j_tables"].starring, top_k=K)
    uf = w["j_model"].user_factors
    return [
        JaxSpec(name="als", kind="user_rows", vectors=w["j_model"].item_factors, item_ids=w["j_matrix"].item_ids,
                user_vectors=uf, exclude_seen=True),
        JaxSpec(name="content", kind="item_mean", vectors=w["backend"].vectors, item_ids=w["backend"].item_ids,
                query_items=provider),
        w["j_search"].bank_registration(query_items=provider),
        JaxSpec(name="user_sim", kind="user_rows", vectors=uf, item_ids=w["j_matrix"].user_ids, user_vectors=uf),
    ]


def _build(cls, specs, matrix, excl, **kw):
    bank = cls(**kw)
    for spec in specs:
        bank.register(spec)
    return bank.build(matrix=matrix, exclude_table=excl)


@pytest.fixture(scope="module")
def banks(world):
    port = _build(RetrievalBank, _port_specs(world), world["matrix"], world["excl"], device="cpu")
    jax_bank = _build(JaxBank, _jax_specs(world), world["j_matrix"], world["excl"])
    return port, jax_bank


def _near(got, want):
    """(ids, scores) pairs: equal up to near-ties at TOL of the largest score."""
    scale = max(1.0, float(np.max(np.abs(want[1]))) if len(want[1]) else 1.0)
    report = candidate_parity(want, got, atol=TOL * scale)
    assert report["ok"], report


def _pairs(bank, name, vals, idx, b):
    ok = (idx[b] >= 0) & np.isfinite(vals[b])
    return bank.specs[name].item_ids[idx[b][ok]], vals[b][ok].astype(np.float64)


def _users(world, n=24):
    matrix = world["matrix"]
    dense = np.arange(0, matrix.n_users, matrix.n_users // n)[:n].astype(np.int64)
    dense[3] = -1  # an unknown user
    raw = np.where(dense >= 0, matrix.user_ids[np.clip(dense, 0, None)], 10**9)
    return dense, raw


def test_query_matches_jax_per_source(world, banks):
    port, jax_bank = banks
    dense, raw = _users(world)
    got = port.query(dense, K, raw_user_ids=raw, exclude_seen=True)
    want = jax_bank.query(dense, K, raw_user_ids=raw, exclude_seen=True)
    for name in SOURCES:
        for b in range(len(dense)):
            _near(_pairs(port, name, *got[name], b), _pairs(jax_bank, name, *want[name], b))
        assert events.retrieval_queries.value(source=name) == len(dense)
    for name in ("als", "user_sim"):  # the unknown user gets no user-row candidates
        assert (got[name][1][3] == -1).all() and np.isneginf(got[name][0][3]).all()


def test_query_matches_the_port_host_paths(world, banks):
    """Each source against the port's own host recommender (K5 paths): the
    bank's candidates are theirs."""
    port, _ = banks
    tables, matrix = world["tables"], world["matrix"]
    dense = np.arange(0, 150, 7, dtype=np.int64)
    raw = matrix.user_ids[dense]
    got = port.query(dense, K, raw_user_ids=raw, exclude_seen=True)
    hosts = {
        "als": ALSRecommender(world["model"], matrix, exclude_seen=True, top_k=K),
        "content": ContentRecommender(world["backend"], tables.starring, top_k=K),
        "tfidf": TfidfRecommender(world["search"], tables.starring, top_k=K),
    }
    for name, rec in hosts.items():
        frame = rec.recommend_for_users(raw)
        for b, u in enumerate(raw):
            rows = frame[frame["user_id"] == int(u)]
            host = rows["repo_id"].to_numpy(np.int64), rows["score"].to_numpy(np.float64)
            _near(_pairs(port, name, *got[name], b), host)


def test_exclusion_and_empty_queries(world, banks):
    port, _ = banks
    matrix = world["matrix"]
    indptr, cols, _ = matrix.csr()
    dense = np.arange(20, dtype=np.int64)
    got = port.query(dense, K, raw_user_ids=matrix.user_ids[dense], exclude_seen=True)
    for b in dense:
        assert not set(got["als"][1][b][got["als"][1][b] >= 0]) & set(cols[indptr[b]:indptr[b + 1]])
    # A user with no stars has no example rows: item_mean sources answer nothing.
    empty = port.query(np.array([0]), K, raw_user_ids=np.array([10**9]), sources=("content", "tfidf"))
    for name in ("content", "tfidf"):
        assert (empty[name][1] == -1).all() and np.isneginf(empty[name][0]).all()
    with pytest.raises(ValueError, match="raw_user_ids"):
        port.query(dense, K, sources=("content",))
    bare = _build(RetrievalBank, _port_specs(world)[:1], matrix, None, device="cpu")
    with pytest.raises(ValueError, match="exclude_table"):
        bare.query(dense, K, exclude_seen=True)


def test_remapped_exclusion_matches_jax(world):
    """A user-row source whose rows are a shuffled subset of the matrix
    items excludes seen items through its remap table."""
    matrix, excl = world["matrix"], world["excl"]
    rng = np.random.default_rng(2)
    keep = np.sort(rng.permutation(matrix.n_items)[:80])[::-1].copy()  # unsorted ids
    uf, vf = world["model"].user_factors, world["model"].item_factors
    spec = dict(name="sub", kind="user_rows", vectors=vf[keep], item_ids=matrix.item_ids[keep],
                user_vectors=uf, exclude_seen=True)
    port = _build(RetrievalBank, [BankSourceSpec(**spec)], matrix, excl, device="cpu")
    jax_bank = _build(JaxBank, [JaxSpec(**spec)], world["j_matrix"], excl)
    dense = np.arange(0, 150, 5, dtype=np.int64)
    got = port.query(dense, K, exclude_seen=True)["sub"]
    want = jax_bank.query(dense, K, exclude_seen=True)["sub"]
    indptr, cols, _ = matrix.csr()
    for b, u in enumerate(dense):
        _near(_pairs(port, "sub", *got, b), _pairs(jax_bank, "sub", *want, b))
        seen = set(matrix.item_ids[cols[indptr[u]:indptr[u + 1]]])
        assert not set(_pairs(port, "sub", *got, b)[0]) & seen


@pytest.mark.parametrize("name", SOURCES)
def test_query_similar_matches_jax(world, banks, name):
    port, jax_bank = banks
    ids = port.specs[name].item_ids
    examples = [ids[:1], ids[5:8], np.array([-777]), ids[[2, 2, 9]]]
    got = port.query_similar(name, examples, K)
    want = jax_bank.query_similar(name, examples, K)
    for g, w in zip(got, want):
        _near(g, w)
    assert got[2][0].size == 0  # no known example: no candidates
    assert not set(got[1][0]) & set(ids[5:8])  # the examples are excluded


def test_kernel_plain_version_matches_the_jax_program(world):
    """``bank_query_reference`` against JAX's ``_make_query_program`` on one
    user-row source with a remapped exclusion and one item-mean source."""
    rng = np.random.default_rng(5)
    uf, vf = world["model"].user_factors, world["model"].item_factors
    emap = rng.permutation(vf.shape[0]).astype(np.int32)
    emap[::7] = -1
    excl = world["excl"]
    user_idx = rng.integers(0, uf.shape[0], size=16).astype(np.int32)
    q_idx = np.full((16, 8), -1, dtype=np.int32)
    for b in range(1, 16):
        n = int(rng.integers(1, 9))
        q_idx[b, :n] = rng.integers(0, vf.shape[0], size=n)
    run = _make_query_program(("user_rows", "item_mean"), (K, K), (True, False), (True, False), K, 4096)
    (jv0, ji0), (jv1, ji1) = run(((jnp.asarray(uf), jnp.asarray(vf), jnp.asarray(emap)), (jnp.asarray(vf),)),
                                 jnp.asarray(user_idx), (None, jnp.asarray(q_idx)), jnp.asarray(excl))
    t = torch.as_tensor
    tv0, ti0 = bank_query_reference(t(vf), K, users=t(uf), user_idx=t(user_idx), exclude_table=t(excl),
                                    excl_map=t(emap))
    tv1, ti1 = bank_query_reference(t(vf), K, q_idx=t(q_idx))
    for (tv, ti), (jv, ji) in (((tv0, ti0), (jv0, ji0)), ((tv1, ti1), (jv1, ji1))):
        for b in range(16):
            ok = ti[b] >= 0
            jok = np.asarray(ji[b]) >= 0
            _near((ti[b][ok].numpy(), tv[b][ok].numpy().astype(np.float64)),
                  (np.asarray(ji[b])[jok], np.asarray(jv[b])[jok].astype(np.float64)))
    assert (ti1[0] == -1).all()  # the row with no query
    # The wrapper on CPU tensors is the plain version.
    got = bank_query(t(vf), K, q_idx=t(q_idx))
    assert torch.equal(got[0], tv1) and torch.equal(got[1], ti1)


def test_mean_query_matches_the_host_twin(world):
    vectors = world["search"].matrix
    rng = np.random.default_rng(8)
    q = np.full((10, 16), -1, dtype=np.int32)
    for b in range(1, 10):
        q[b, : b + 1] = rng.integers(0, vectors.shape[0], size=b + 1)
    got, has = mean_query_reference(torch.as_tensor(vectors), torch.as_tensor(q))
    want, want_has = mean_query_vectors(vectors, q)
    np.testing.assert_array_equal(has.numpy(), want_has)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_calibration_and_manifest_equal_jax(banks):
    port, jax_bank = banks
    for name in SOURCES:
        got, want = port.calibration[name], jax_bank.calibration[name]
        assert got["probe_rows"] == want["probe_rows"]
        for key in ("scale", "row_norm_mean", "row_norm_max"):
            assert got[key] == pytest.approx(want[key], rel=1e-6, abs=0)
    assert port.version == jax_bank.version  # the same digest of the same tables
    assert port.manifest()["sources"] == jax_bank.manifest()["sources"]


def test_publish_user_rows_matches_jax(world):
    port = _build(RetrievalBank, _port_specs(world), world["matrix"], world["excl"], device="cpu")
    jax_bank = _build(JaxBank, _jax_specs(world), world["j_matrix"], world["excl"])
    before = world["model"].user_factors.copy()
    rows = np.random.default_rng(6).standard_normal((3, RANK)).astype(np.float32)
    dense_rows = np.array([4, 40, 99])
    assert port.publish_user_rows("als", dense_rows, rows) == jax_bank.publish_user_rows("als", dense_rows, rows) == 1
    got = port.query(dense_rows, K, exclude_seen=True, sources=("als",))["als"]
    want = jax_bank.query(dense_rows, K, exclude_seen=True, sources=("als",))["als"]
    for b in range(3):
        _near(_pairs(port, "als", *got, b), _pairs(jax_bank, "als", *want, b))
    np.testing.assert_array_equal(world["model"].user_factors, before)  # the model is untouched
    np.testing.assert_array_equal(port.specs["als"].user_vectors[dense_rows], rows)
    with pytest.raises(ValueError, match="no user-row table"):
        port.publish_user_rows("content", dense_rows, rows)


def test_default_bank_and_fault_sites(world):
    faults.arm("retrieval.query", "error", at=1)
    bank = build_default_bank(world["model"], world["matrix"], starring_df=world["tables"].starring,
                              content_backend=world["backend"], tfidf_search=world["search"],
                              with_user_sim=True, exclude_table=world["excl"], device="cpu")
    assert bank.source_names == ("als", "content", "tfidf", "user_sim")
    assert faults.FAULTS.hits("retrieval.build") == 1
    with pytest.raises(faults.FaultInjected):
        bank.query(np.array([0]), K)
    assert bank.query(np.array([0]), K, raw_user_ids=world["matrix"].user_ids[:1])["als"][1].shape == (1, K)


def test_unported_layouts_raise(world, banks):
    port, _ = banks
    with pytest.raises(NotImplementedError, match="not ported yet"):
        RetrievalBank(device="cpu").build(mesh=object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        _build(RetrievalBank, _port_specs(world)[:1], world["matrix"], None, device="cpu").reshard(object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port.save("x")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        RetrievalBank.load("x")
