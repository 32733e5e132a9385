"""K1-K3 plain versions and the half-sweep against the JAX package's ops on
the same numpy inputs (CPU). Tolerance rtol 1e-5, atol 1e-6: float32 with
another summation order (measured max |diff| ~1e-6). Under bf16 gathers
(``gather_dtype="bfloat16"``) the plain versions round where JAX rounds and
every product over the gathered rows is exact in float32, so the same
tolerance holds: the sums' order is the only difference."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.datasets.ragged import grouped_bucket_rows
from albedo_tpu.datasets.synthetic import synthetic_stars
from albedo_tpu.models.als import _landing_perm
from albedo_tpu.ops import als as jals
from albedo_tpu_torch.datasets.ragged import Bucket, to_device
from albedo_tpu_torch.kernels.als_partials_bench import BENCH_GROUPS, WIDE_GROUPS
from albedo_tpu_torch.ops import als as tals

RTOL, ATOL = 1e-5, 1e-6
REG, ALPHA = 0.5, 40.0


def _bucket(k, b=12, length=19, n_source=90, n_pad=3, seed=0):
    """A padded bucket as ``datasets.ragged`` lays it out: front-packed
    entries, idx 0 / val 0 off the mask, the last slots all padding."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
    lens = rng.integers(1, length + 1, size=b)
    lens[b - n_pad:] = 0
    lens[0] = length
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 1.5, size=(b, length)), 0).astype(np.float32)
    x0 = (rng.standard_normal((b, k)) * 0.1).astype(np.float32)
    return src, idx, val, mask, x0


def _jax_partials(src, idx, val, mask):
    c1 = (ALPHA * val).astype(np.float32)
    w = np.where(mask, 1.0 + c1, 0.0).astype(np.float32)
    return jals.bucket_partial_terms(jnp.asarray(src[idx]), jnp.asarray(c1), jnp.asarray(w))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.fixture
def one_thread():
    """Torch's CPU ops on one thread for the test: the order models run
    thousands of small ops, which a pool of threads contending with other
    test processes for the cores slows many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [8, 50])
def test_k1_partial_terms(k):
    src, idx, val, mask, _ = _bucket(k)
    jc, jb = _jax_partials(src, idx, val, mask)
    tc, tb = tals.bucket_partial_terms(*_t(src, idx, val, mask), ALPHA)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL, atol=ATOL)
    assert not tc[-1].any() and not tb[-1].any()  # padding slot: zero terms


@pytest.mark.parametrize("k", [8, 50])
def test_k2_solve_corrected(k):
    src, idx, val, mask, _ = _bucket(k)
    jc, jb = _jax_partials(src, idx, val, mask)
    yty = src.T @ src
    n_b = mask.sum(1).astype(np.float32)
    jx = jals.solve_corrected(jnp.asarray(yty), jc, jb, jnp.asarray(n_b), jnp.float32(REG))
    tx = tals.solve_corrected(
        torch.as_tensor(yty), torch.as_tensor(np.array(jc)), torch.as_tensor(np.array(jb)),
        torch.as_tensor(n_b), REG,
    )
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


GATHER_DTYPES = [None, "bfloat16"]


@pytest.mark.parametrize("gather_dtype", GATHER_DTYPES)
@pytest.mark.parametrize("k", [8, 50, 100])
def test_k1_k2_bucket_solve_body(k, gather_dtype):
    # Wider ranks draw from more source rows, so a padding slot's YtY stays regular.
    src, idx, val, mask, _ = _bucket(k, seed=1, n_source=max(90, 2 * k))
    yty = src.T @ src
    jx = jals.bucket_solve_body(
        jnp.asarray(src), jnp.asarray(yty), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(mask), jnp.float32(REG), jnp.float32(ALPHA), gather_dtype=gather_dtype,
    )
    tx = tals.bucket_solve_body(*_t(src, yty, idx, val, mask), REG, ALPHA, gather_dtype=gather_dtype)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


def _jax_cg(src, yty, idx, val, mask, x0, cg_steps, gather_dtype):
    return np.asarray(jals.bucket_cg_body(
        jnp.asarray(src), jnp.asarray(yty), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(mask), jnp.asarray(x0), jnp.float32(REG), jnp.float32(ALPHA), cg_steps,
        gather_dtype=gather_dtype,
    ))


@pytest.mark.parametrize("gather_dtype", GATHER_DTYPES)
@pytest.mark.parametrize("k", [8, 50, 100])
@pytest.mark.parametrize("cg_steps", [1, 3])
def test_k3_bucket_cg(k, cg_steps, gather_dtype):
    src, idx, val, mask, x0 = _bucket(k, seed=2, n_source=max(90, 2 * k))
    yty = src.T @ src
    jx = _jax_cg(src, yty, idx, val, mask, x0, cg_steps, gather_dtype)
    tx = tals.bucket_cg_body(*_t(src, yty, idx, val, mask, x0), REG, ALPHA, cg_steps, gather_dtype=gather_dtype)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("site", ["y*y", "t"])
def test_k3_bf16_rounding_sites(site, monkeypatch):
    """K3-bf16's plain version rounds ``y * y`` (the Jacobi diagonal) and
    ``t = c1 q`` (the second gathered contraction) to bf16, as the JAX
    program does: with either rounding left out it leaves the tolerance the
    full version keeps."""
    src, idx, val, mask, x0 = _bucket(8, seed=2)
    yty = src.T @ src
    jx = _jax_cg(src, yty, idx, val, mask, x0, 3, "bfloat16")
    args = (*_t(src, yty, idx, val, mask, x0), REG, ALPHA, 3, "bfloat16")
    np.testing.assert_allclose(tals.bucket_cg_reference(*args).numpy(), jx, rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(tals, "_round", _omitting(site, *idx.shape, src.shape[1]))
    omitted = tals.bucket_cg_reference(*args).numpy()
    assert not np.allclose(omitted, jx, rtol=RTOL, atol=ATOL)


def _omitting(site: str, b: int, length: int, k: int):
    """``ops.als._round`` with one of K3-bf16's rounding sites left out. The
    plain version rounds, in order: y*y (B, L, k), the diagonal's c1 (B, L),
    then per matvec p (B, k) and t (B, L)."""
    rounding, seen = tals._round, []

    def omit_site(x, gather_dtype):
        shape = tuple(x.shape)
        seen.append(shape)
        first_bl = shape == (b, length) and seen.count((b, length)) == 1
        skip = {"y*y": shape == (b, length, k), "c1 of the diagonal": first_bl, "p": shape == (b, k),
                "t": shape == (b, length) and not first_bl}[site]
        return x if skip else rounding(x, gather_dtype)

    return omit_site


def test_k3_bf16_tolerance_separates_round_off_from_a_missing_site(monkeypatch):
    """The card holds K3-bf16 to rel 5e-4 of its plain version (K3 itself:
    1e-4). Another float32 summation order (each row's entries reversed) can
    flip a bf16 rounding of the iterate and stays within 1e-4 here, while
    leaving out any one of K3-bf16's rounding sites moves the result past
    5e-4, on a bench-shaped bucket (rank 50, 48 rows of up to 400 entries)."""
    rng = np.random.default_rng(31)
    k, b, length, n_source = 50, 48, 400, 19991
    src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32))
    lens = rng.integers(1, length + 1, size=b)
    lens[-4:] = 0
    lens[0] = length
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 1.5, size=(b, length)), 0.0).astype(np.float32)
    x0 = torch.as_tensor((rng.standard_normal((b, k)) * 0.1).astype(np.float32))
    yty = tals.gramian(src)

    def solve(i, v):
        return tals.bucket_cg_reference(src, yty, torch.as_tensor(i), torch.as_tensor(v), torch.as_tensor(mask),
                                        x0, REG, ALPHA, 3, "bfloat16")

    want = solve(idx, val)
    scale = float(want.abs().max())
    rev_idx, rev_val = idx.copy(), val.copy()
    for r, n in enumerate(lens):
        rev_idx[r, :n], rev_val[r, :n] = idx[r, :n][::-1], val[r, :n][::-1]
    assert float((solve(rev_idx, rev_val) - want).abs().max()) <= 1e-4 * scale
    rounding = tals._round
    for site in ("y*y", "c1 of the diagonal", "p", "t"):
        monkeypatch.setattr(tals, "_round", _omitting(site, b, length, k))
        assert float((solve(idx, val) - want).abs().max()) > 5e-4 * scale, site
        monkeypatch.setattr(tals, "_round", rounding)


def test_k3_bf16_long_rows_flip_under_reordering():
    """Why the card holds K3-bf16 to its plain version at every bench group
    shape only in float32 (``tests/test_torch_cuda.py::
    test_k3_split_design_at_the_bench_groups``): on that test's bucket of 16
    rows of up to 2152 entries at rank 50, merely reversing each row's
    entries moves the plain bf16 result past 5e-4 (a float32 round-off flips
    bf16 roundings of p and t), while float32 moves under 1e-5."""
    rng = np.random.default_rng(16 + 2152)
    b, length, k, n_source = 16, 2152, 50, 20000
    src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32))
    lens = rng.integers(length // 2, length + 1, size=b)
    lens[rng.random(b) < 0.25] = 0
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 3.0, size=(b, length)), 0).astype(np.float32)
    x0 = torch.as_tensor((np.random.default_rng(16 + 2152).standard_normal((b, k)) * 0.1).astype(np.float32))
    rev_idx, rev_val = idx.copy(), val.copy()
    for r, n in enumerate(lens):
        rev_idx[r, :n], rev_val[r, :n] = idx[r, :n][::-1], val[r, :n][::-1]
    yty = tals.gramian(src)

    def moved(gather_dtype):
        a, c = (tals.bucket_cg_reference(src, yty, torch.as_tensor(i), torch.as_tensor(v), torch.as_tensor(mask), x0,
                                         REG, ALPHA, 3, gather_dtype) for i, v in ((idx, val), (rev_idx, rev_val)))
        return float((a - c).abs().max() / a.abs().max())

    assert moved(None) < 1e-5
    assert moved("bfloat16") > 5e-4


@pytest.mark.parametrize("gather_dtype", GATHER_DTYPES)
@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_half_sweep_with_landing(solver, gather_dtype):
    """One item half-sweep with landing == ``scan_half_sweep`` (rows in no
    bucket keep their old factor). Under bf16 gathers the JAX sweep runs op
    by op (``jax.disable_jit``), as the program is written: compiled for the
    CPU, XLA may keep the CG diagonal's ``y * y`` in float32 (excess
    precision is allowed), a rounding the port keeps."""
    m = synthetic_stars(n_users=120, n_items=80, mean_stars=6, seed=4)
    k = 8
    rng = np.random.default_rng(11)
    user_f = (rng.standard_normal((m.n_users, k)) / np.sqrt(k)).astype(np.float32)
    item_f = (rng.standard_normal((m.n_items + 5, k)) / np.sqrt(k)).astype(np.float32)
    groups = grouped_bucket_rows(*m.csc(), batch_size=16, max_entries=400)
    landing = _landing_perm(groups, item_f.shape[0])
    with jax.disable_jit(gather_dtype is not None):
        jx = jals.scan_half_sweep(
            jnp.asarray(user_f), jnp.asarray(item_f),
            [Bucket(*(jnp.asarray(a) for a in (g.row_ids, g.idx, g.val, g.mask))) for g in groups],
            jnp.float32(REG), jnp.float32(ALPHA), solver, 3, jnp.asarray(landing), gather_dtype,
        )
    tx = tals.half_sweep(
        torch.as_tensor(user_f), torch.as_tensor(item_f),
        [to_device(g, "cpu") for g in groups], torch.as_tensor(landing).long(),
        REG, ALPHA, solver, 3, gather_dtype,
    )
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tx.numpy()[-5:], item_f[-5:])


def test_implicit_loss():
    m = synthetic_stars(n_users=40, n_items=30, mean_stars=5, seed=1)
    rng = np.random.default_rng(2)
    uf = rng.standard_normal((m.n_users, 6)).astype(np.float32)
    vf = rng.standard_normal((m.n_items, 6)).astype(np.float32)
    j = jals.implicit_loss(
        jnp.asarray(uf), jnp.asarray(vf), jnp.asarray(m.rows), jnp.asarray(m.cols),
        jnp.asarray(m.vals), REG, ALPHA,
    )
    t = tals.implicit_loss(*_t(uf, vf, m.rows, m.cols, m.vals), REG, ALPHA)
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def test_unknown_solver_and_mixed_devices_raise():
    src, idx, val, mask, _ = _bucket(8)
    with pytest.raises(ValueError, match="unknown solver"):
        tals.half_sweep(torch.as_tensor(src), torch.as_tensor(src), [], torch.zeros(0).long(),
                        REG, ALPHA, solver="lu")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        tals.bucket_partial_terms(
            torch.as_tensor(src), torch.as_tensor(idx), torch.as_tensor(val),
            torch.as_tensor(mask).to("meta"), ALPHA,
        )


# ------------------------------------------------------------------- K4


def _solved_groups(seed=5, k=7):
    """Bucket groups of an item half-sweep (with -1 padding slots and rows
    in no bucket) and random solved blocks shaped like them."""
    m = synthetic_stars(n_users=90, n_items=60, mean_stars=5, seed=seed)
    groups = grouped_bucket_rows(*m.csc(), batch_size=16, max_entries=300)
    rng = np.random.default_rng(seed)
    n_target = m.n_items + 4  # four rows in no bucket
    target = rng.standard_normal((n_target, k)).astype(np.float32)
    solved = [rng.standard_normal((g.row_ids.size, k)).astype(np.float32) for g in groups]
    return groups, target, solved


def test_k4_scatter_solved_matches_jax():
    """``scatter_solved``'s plain version equals JAX's (exactly): -1 slots
    drop, rows in no bucket keep their old factor."""
    groups, target, solved = _solved_groups()
    rows = np.concatenate([g.row_ids.reshape(-1) for g in groups])
    flat = np.concatenate(solved)
    assert (rows < 0).any()
    want = np.asarray(jals.scatter_solved(jnp.asarray(target), jnp.asarray(rows), jnp.asarray(flat)))
    got = tals.scatter_solved(torch.as_tensor(target), torch.as_tensor(rows), torch.as_tensor(flat))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[-4:], target[-4:])
    # The reference takes the row ids in their (N, B) group shape too.
    g0 = groups[0]
    want0 = np.asarray(jals.scatter_solved(jnp.asarray(target), jnp.asarray(g0.row_ids.reshape(-1)),
                                           jnp.asarray(solved[0])))
    got0 = tals.scatter_solved(torch.as_tensor(target), torch.as_tensor(g0.row_ids),
                               torch.as_tensor(solved[0]).reshape(g0.row_ids.shape + (-1,)))
    np.testing.assert_array_equal(got0.numpy(), want0)


def test_k4_land_rows_matches_jax_landing():
    """``land_rows``'s plain version on the pool of solved blocks is
    ``scan_half_sweep``'s landing gather (``concat(solved..., target)
    [landing]``) exactly, and equals the scatter of the same blocks."""
    groups, target, solved = _solved_groups(seed=6)
    landing = _landing_perm(groups, target.shape[0])
    want = np.asarray(jnp.concatenate([jnp.asarray(b) for b in solved] + [jnp.asarray(target)])[landing])
    got = tals.land_rows(torch.as_tensor(target), torch.as_tensor(np.concatenate(solved)),
                         torch.as_tensor(landing).long())
    np.testing.assert_array_equal(got.numpy(), want)
    rows = np.concatenate([g.row_ids.reshape(-1) for g in groups])
    scattered = jals.scatter_solved(jnp.asarray(target), jnp.asarray(rows), jnp.asarray(np.concatenate(solved)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scattered))
    keep = tals.land_rows(torch.as_tensor(target), torch.zeros((0, target.shape[1])), torch.arange(target.shape[0]))
    np.testing.assert_array_equal(keep.numpy(), target)  # no blocks: every row keeps its factor


# --------------------------------------------------- K1's split design (plan)
#
# The card's K1 (csrc/als_partials.cu) cuts each row of a group into chunks
# (``ops.als._k1_plan``), sums each (row, chunk) unit on its own and adds a
# split row's partials in chunk order, then mirrors the upper triangle. The
# plan and the block layout are mirrored in Python; these tests hold the
# mirror (every slot covered once, in order) and a model of the kernel's
# arithmetic built on it (against JAX and the plain version).

N_SM = 132  # an H100's SMs
K1_EDGES = [(1, 1), (4, 1), (1, 7624), (3, 0), (5, 31), (5, 33), (2, 64), (2, 65), (7, 2000), (131, 700)]


@pytest.mark.parametrize("b, length", BENCH_GROUPS + WIDE_GROUPS + K1_EDGES)
def test_k1_plan_covers_each_slot_once_in_order(b, length):
    plan = tals._k1_plan(b, length, N_SM)
    chunk, n_chunks, per_cta = plan
    assert chunk % tals.K1_TILE == 0 and chunk >= tals.K1_TILE
    assert n_chunks == max(1, -(-length // chunk))
    assert per_cta == 1 or n_chunks == 1
    units = tals.k1_units(b, length, plan)
    assert len(units) == b * n_chunks
    per = Counter(u[0] for u in units)
    assert sorted(per) == list(range(-(-len(units) // per_cta))) and max(per.values(), default=1) <= per_cta
    cover = np.zeros((b, length), dtype=np.int64)
    parts: dict[int, list] = {}
    for _, row, c, start, end in units:
        cover[row, start:end] += 1
        parts.setdefault(row, []).append((c, start, end))
    assert (cover == 1).all()
    for row in range(b):
        got = parts[row]
        assert [c for c, _, _ in got] == list(range(n_chunks))       # walked (and added) in chunk order
        assert got[0][1] == 0 and got[-1][2] == length
        assert all(a[2] == z[1] for a, z in zip(got, got[1:]))      # contiguous
    # A group with few rows is spread over the card: at least half the units
    # the plan aims for, unless every row is already cut to its shortest chunks.
    if 2 * b < tals.K1_UNITS_PER_SM * N_SM and length > tals.K1_MIN_CHUNK:
        want = tals.K1_UNITS_PER_SM * N_SM // 2
        assert len(units) >= min(want, b * (length // tals.K1_MIN_CHUNK))


@pytest.mark.parametrize("k", [65, 100, 256, 512])
@pytest.mark.parametrize("b, length", [(1, 7624), (4, 800), (131, 700), (512, 300)])
def test_k1_plan_keeps_split_partials_within_the_workspace(b, length, k):
    """With a unit's partial of 16 k1_blocks(k) floats, a split plan's
    partials fit in WORKSPACE_MAX bytes (at rank 512 the 131 x 700 group is
    cut into fewer chunks than the card's SMs ask for, and still split), and
    the plan still covers every slot once."""
    unit = 16 * tals.k1_blocks(k)
    plan = tals._k1_plan(b, length, N_SM, unit)
    chunk, n_chunks, _ = plan
    assert n_chunks == 1 or 4 * b * n_chunks * unit <= tals.WORKSPACE_MAX
    assert n_chunks <= tals._k1_plan(b, length, N_SM)[1]
    if (b, length, k) == (131, 700, 512):
        assert 1 < n_chunks < tals._k1_plan(b, length, N_SM)[1]
    cover = np.zeros((b, length), dtype=np.int64)
    for _, row, _, start, end in tals.k1_units(b, length, plan):
        cover[row, start:end] += 1
    assert (cover == 1).all()


def test_wide_groups_are_the_rank_100_fits():
    """``WIDE_GROUPS`` (the CPU plan tests' shapes of the rank-100 fit) are
    ``ImplicitALS(rank=100).device_groups`` of the ``train_als`` job's
    tables, items' half-sweep then users', as the bench and ``chip_smoke.py``
    build them."""
    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import JobContext
    from albedo_tpu_torch.models.als import ImplicitALS

    matrix = JobContext(cli.parse_args(["train_als", "--device", "cpu"])).matrix()
    ug, ig, _, _ = ImplicitALS(rank=100, device="cpu").device_groups(matrix)
    assert [(g.idx.shape[0] * g.idx.shape[1], g.idx.shape[2]) for g in ig + ug] == WIDE_GROUPS


def _kernel_blocks(k):
    """The kernel's thread -> 4 x 4 block (I, J) walk (als_split_kernel)."""
    kbi, kbj = -(-k // 4), (k + 4) // 4
    out = []
    for t in range(tals.k1_blocks(k)):
        i_blk = 0
        while t >= kbj - i_blk:
            t -= kbj - i_blk
            i_blk += 1
        out.append((i_blk, i_blk + t))
    return kbi, kbj, out


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 16, 49, 50, 63, 64])
def test_k1_blocks_cover_the_upper_triangle_and_the_b_column(k):
    kbi, kbj, blocks = _kernel_blocks(k)
    assert len(blocks) <= 160 and len(set(blocks)) == len(blocks)    # NT_MAX threads
    assert set(blocks) == {(i, j) for i in range(kbi) for j in range(i, kbj)}
    owner = {blk: t for t, blk in enumerate(blocks)}
    for i in range(k):
        for j in range(i, k + 1):  # column k is the b-vector
            bi, bj = i // 4, j // 4
            assert bi * kbj - bi * (bi - 1) // 2 + (bj - bi) == owner[(bi, bj)]  # als_close_kernel's index


def _close_to_scale(got, want):
    """Within RTOL of the largest |want| of the row block: a row of
    thousands of entries sums terms that cancel (a correction of ~6000 has
    elements near 1), so two summation orders part by ~1e-8 of the scale,
    which the elementwise rtol would read as 3e-5 on the small elements."""
    assert np.abs(got - want).max(initial=0.0) <= RTOL * max(np.abs(want).max(initial=0.0), 1e-30)


def _k1_split_model(src, idx, val, mask, plan, gather_dtype=None):
    """K1 as the split design computes it, on the CPU: each unit's partial
    over its slots, a split row's partials added in chunk order, the upper
    triangle mirrored."""
    b, length = idx.shape
    k = src.shape[1]
    corr, bvec = torch.zeros((b, k, k)), torch.zeros((b, k))
    for _, row, _, start, end in tals.k1_units(b, length, plan):
        part = (t[row:row + 1, start:end] for t in (idx, val, mask))
        pc, pb = tals.bucket_partial_terms_reference(src, *part, ALPHA, gather_dtype)
        corr[row] += pc[0]
        bvec[row] += pb[0]
    return torch.triu(corr) + torch.triu(corr, 1).transpose(1, 2), bvec


def _k1_bucket(k, b, length, n_source=300, n_pad=1, gaps=False, seed=0):
    """A bucket as ``_bucket`` builds it, with optional masked gaps inside
    rows (idx 0 / val 0 off the mask, as the layout keeps padding)."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
    lens = rng.integers(max(1, length // 2), length + 1, size=b)
    lens[b - n_pad:] = 0
    mask = np.arange(length)[None, :] < lens[:, None]
    if gaps:
        mask &= rng.random((b, length)) > 0.3
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 1.5, size=(b, length)), 0).astype(np.float32)
    return src, idx, val, mask


@pytest.mark.parametrize("gather_dtype", GATHER_DTYPES)
@pytest.mark.parametrize("k", [1, 50, 64, 65, 100, 129])
@pytest.mark.parametrize("b, length, n_pad, gaps", [
    (4, 1, 1, False), (1, 7624, 0, False), (6, 300, 3, False), (5, 700, 1, True),
], ids=["L1", "one-row-7624", "all-padding-slots", "masked-gaps"])
def test_k1_split_model_matches_jax(b, length, n_pad, gaps, k, gather_dtype):
    src, idx, val, mask = _k1_bucket(k, b, length, n_pad=n_pad, gaps=gaps)
    plan = tals._k1_plan(b, length, N_SM)
    corr, bvec = _k1_split_model(*_t(src, idx, val, mask), plan, gather_dtype)
    assert torch.equal(corr, corr.transpose(1, 2))
    if gather_dtype is None:
        jc, jb = _jax_partials(src, idx, val, mask)
    else:
        jc, jb = tals.bucket_partial_terms(*_t(src, idx, val, mask), ALPHA, gather_dtype)
    for got, want in ((corr.numpy(), np.asarray(jc)), (bvec.numpy(), np.asarray(jb))):
        _close_to_scale(got, want)
    if n_pad:
        assert not corr[-1].any() and not bvec[-1].any()


def test_k1_split_model_on_a_fits_groups():
    """Every bucket group of a reduced fit (both half-sweeps), planned for a
    card of 4 SMs so that the small groups split: the model of the split
    design against the plain version."""
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars as port_stars
    from albedo_tpu_torch.models.als import ImplicitALS

    m = port_stars(n_users=300, n_items=200, mean_stars=40, seed=3)
    ug, ig, _, _ = ImplicitALS(rank=8, device="cpu").device_groups(m)
    rng = np.random.default_rng(1)
    tables = {"u": torch.as_tensor(rng.standard_normal((m.n_users, 8)).astype(np.float32)),
              "i": torch.as_tensor(rng.standard_normal((m.n_items, 8)).astype(np.float32))}
    split = 0
    for src, groups in ((tables["u"], ig), (tables["i"], ug)):
        for g in groups:
            n, b, length = g.idx.shape
            idx, val, mask = (t.reshape(n * b, length) for t in (g.idx, g.val, g.mask))
            plan = tals._k1_plan(n * b, length, 4)
            split += plan[1] > 1
            corr, bvec = _k1_split_model(src, idx, val, mask, plan)
            want = tals.bucket_partial_terms_reference(src, idx, val, mask, ALPHA)
            _close_to_scale(corr.numpy(), want[0].numpy())
            _close_to_scale(bvec.numpy(), want[1].numpy())
    assert split > 0


# ------------------------------------------------- K2's wide path (blocked)
#
# Above rank 64 the card's K2 (csrc/solve_corrected.cu) factors the bordered
# matrix [[A, b], [b^T, .]] by panels of 32 columns: the diagonal block
# column by column, the rows below it (b's row included) against L11^T,
# then the trailing lower triangle less the panel's products summed over
# the panel; L^T x = y by the same panels from the last. A model of that
# order in float32 against the JAX ``solve_corrected``: rtol 1e-5, atol
# 1e-6 as the other K1-K3 parity tests (the order is the only difference).


def _k2_wide_model(yty, corr, b_vec, n_b, reg, nb=32):
    """K2's wide path in its blocked order (float32, every system at once):
    A's lower triangle from the upper triangle of YtY + corr (the kernel
    reads that triangle), reg n_b on the diagonal, b in row k."""
    n, k = b_vec.shape
    m = torch.zeros((n, k + 1, k + 1))
    m[:, :k, :k] = torch.tril((yty[None] + corr).transpose(1, 2)) + (reg * n_b)[:, None, None] * torch.eye(k)
    m[:, k, :k] = b_vec
    dinv = torch.zeros((n, k))
    for p0 in range(0, k, nb):
        r0 = min(k, p0 + nb)
        for j in range(p0, r0):  # the diagonal block and the rows below it, column by column
            for p in range(p0, j):
                m[:, j:, j] -= m[:, j:, p] * m[:, j:j + 1, p]
            dinv[:, j] = torch.rsqrt(m[:, j, j])
            m[:, j + 1:, j] *= dinv[:, j:j + 1]
        if r0 < k:
            panel = m[:, r0:, p0:r0]
            m[:, r0:, r0:k] -= torch.tril(panel @ panel.transpose(1, 2))[:, :, :k - r0]
    y = m[:, k, :k].clone()
    for p0 in range((k - 1) // nb * nb, -1, -nb):
        r0 = min(k, p0 + nb)
        for j in range(r0 - 1, p0 - 1, -1):
            y[:, j] *= dinv[:, j]
            y[:, p0:j] -= m[:, j, p0:j] * y[:, j:j + 1]
        y[:, :p0] -= torch.einsum("bji,bj->bi", m[:, p0:r0, :p0], y[:, p0:r0])
    return y


@pytest.mark.parametrize("k", [65, 100, 129])
def test_k2_wide_model_matches_jax(k):
    """K2's blocked order at ranks 65 (a panel of one column), 100 and 129
    (a last panel of one column), a bucket with padding rows (n_b = 0, A =
    YtY, positive definite here): within rtol 1e-5, atol 1e-6 of JAX."""
    src, idx, val, mask, _ = _bucket(k, seed=k, n_source=2 * k + 40)
    jc, jb = _jax_partials(src, idx, val, mask)
    yty = src.T @ src
    n_b = mask.sum(1).astype(np.float32)
    assert (n_b == 0).sum() == 3
    want = jals.solve_corrected(jnp.asarray(yty), jc, jb, jnp.asarray(n_b), jnp.float32(REG))
    got = _k2_wide_model(*_t(yty, np.array(jc), np.array(jb), n_b), REG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# --------------------------------------------------- K3's split design (plan)
#
# The card's K3 (csrc/bucket_cg.cu) packs short rows one warp a row and cuts
# longer rows into slices across the CTAs of a thread-block cluster
# (``ops.als._k3_plan``), each CTA holding its slice in shared memory (or
# streaming it when it does not fit) and the cluster adding each pass's
# partial k-vectors in rank order. The plan and its shared memory are
# mirrored in Python; these tests hold the mirror (every slot covered once,
# cluster sizes, shared bytes, the resident-or-streamed choice) and a model
# of the kernel's summation order built on it (against JAX).

K3_EDGES = [(1, 0), (4, 1), (5, 31), (5, 32), (5, 33), (3, 64), (3, 65), (2, 129), (1, 7624), (7, 2000),
            (131, 700), (1, 20000)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b, length", BENCH_GROUPS + K3_EDGES)
def test_k3_plan_covers_each_live_slot_once(b, length, bf16):
    plan = tals._k3_plan(b, length, 50, bf16, N_SM)
    mode, c, slice_, resident = plan
    units = tals.k3_units(b, length, plan)
    cover = np.zeros((b, length), dtype=np.int64)
    ranks: dict[int, list] = {}
    for cta, row, rank, start, end in units:
        assert 0 <= start <= end <= length
        cover[row, start:end] += 1
        ranks.setdefault(row, []).append((rank, start, end))
        assert cta == (row // tals.K3_PACK_WARPS if mode == 0 else row * c + rank)
    assert (cover == 1).all()
    for row in range(b):
        got = ranks[row]
        assert [r for r, _, _ in got] == list(range(c if mode == 1 else 1))  # added in rank order
        assert all(a[2] == z[1] for a, z in zip(got, got[1:]))              # contiguous slices
    if mode == 0:
        assert length <= tals.K3_PACK_L and slice_ >= length and slice_ % 4 == 0 and resident
    else:
        assert length > tals.K3_PACK_L and slice_ % 32 == 0 and -(-length // c) <= slice_ < -(-length // c) + 32


@pytest.mark.parametrize("c_max", [8, 16])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [8, 16, 50, 64])
def test_k3_cluster_sizes_and_shared_bytes(k, bf16, c_max):
    """Cluster sizes are powers of two up to the portable 8, or 16 where the
    card holds such clusters (``c_max``); every plan's shared bytes a CTA
    stay under the 227 KB a block may opt into; a group of few rows is
    spread until it has a CTA an SM or the widest cluster is reached."""
    for b, length in BENCH_GROUPS + K3_EDGES:
        plan = tals._k3_plan(b, length, k, bf16, N_SM, c_max)
        mode, c, _, resident = plan
        assert c in tals.K3_CLUSTERS and c <= c_max
        assert tals.k3_smem(plan, k, bf16) <= tals.K3_SMEM < 227 * 1024 + 1
        if mode == 1 and c < c_max:
            assert b * c >= N_SM and resident


@pytest.mark.parametrize("bf16", [False, True])
def test_k3_resident_or_streamed_at_the_bench_groups(bf16):
    """From the shapes alone: at rank 50 every bench group's slice stays in
    shared memory, with clusters of 16 and with the portable 8 alike (the
    7624-slot row at c = 8 is 960 slots, 225 920 bytes in float32); the
    choice is resident exactly when the resident slice fits; and a slice too
    long even at the widest cluster is streamed in small windows."""
    for c_max in (8, 16):
        for b, length in BENCH_GROUPS:
            plan = tals._k3_plan(b, length, 50, bf16, N_SM, c_max)
            assert plan[3] == 1
            assert plan[0] == (0 if length <= tals.K3_PACK_L else 1)
            if plan[0] == 1:
                assert tals.k3_smem(plan, 50, bf16) <= tals.K3_SMEM
    assert tals.k3_smem(tals._k3_plan(1, 7624, 50, False, N_SM, 8), 50, False) == 225920
    for length in (30000, 40000):
        plan = tals._k3_plan(1, length, 64, bf16, N_SM)
        resident_plan = (1, plan[1], plan[2], 1)
        assert plan[3] == 0 and tals.k3_smem(resident_plan, 64, bf16) > tals.K3_SMEM
        assert tals.k3_smem(plan, 64, bf16) < 64 * 1024


def _k3_cluster_model(src, yty, idx, val, mask, x0, plan, cg_steps, gather_dtype=None):
    """K3 as the split design sums it, on the CPU: each unit's partial of
    b, of the diagonal's sum and of every matvec's gathered term over its
    slots, a row's partials added in the plan's rank order, then the k-length
    CG update (JAX's order)."""
    def rnd(x):
        return tals._round(x, gather_dtype)

    b, length = idx.shape
    table = tals.gather_table(src, gather_dtype)
    rows: dict[int, list] = {}
    for _, row, _, start, end in tals.k3_units(b, length, plan):
        g = table[idx[row, start:end].long()].float()
        c1 = ALPHA * val[row, start:end]
        w = torch.where(mask[row, start:end], 1.0 + c1, torch.zeros_like(c1))
        rows.setdefault(row, []).append((g, c1, w, int(mask[row, start:end].sum())))
    out = torch.empty_like(x0)
    for row, units in rows.items():
        def ranked(part):
            acc = torch.zeros(src.shape[1])
            for u in units:
                acc = acc + part(*u)
            return acc

        rn = REG * float(sum(u[3] for u in units))
        b_vec = ranked(lambda g, c1, w, n: w @ g)
        diag = torch.clamp(torch.diagonal(yty) + ranked(lambda g, c1, w, n: rnd(c1) @ rnd(g * g)) + rn, min=1e-12)

        def matvec(p):
            s = ranked(lambda g, c1, w, n: rnd(c1 * (g @ rnd(p))) @ g)
            return p @ yty + s + rn * p

        tiny = 1e-30
        x = x0[row]
        r = b_vec - matvec(x)
        z = r / diag
        p = z
        rz = torch.sum(r * z)
        for _ in range(cg_steps):
            ap = matvec(p)
            step = rz / (torch.sum(p * ap) + tiny)
            x = x + step * p
            r = r - step * ap
            z = r / diag
            rz_new = torch.sum(r * z)
            beta = rz_new / (rz + tiny)
            p = z + beta * p
            rz = rz_new
        out[row] = x
    return out


@pytest.mark.parametrize("cg_steps", [0, 1, 3])
@pytest.mark.parametrize("b, length", [(1, 700), (2, 300), (8, 96)], ids=["1x700", "2x300", "8x96"])
def test_k3_cluster_model_matches_jax(b, length, cg_steps):
    """Scaled-down narrow groups at rank 16, split as the card splits them
    (clusters of 16: slices of 64, 32 and 32 slots), summed unit by unit in
    rank order: within the tolerance of the JAX function."""
    src, idx, val, mask = _k1_bucket(16, b, length, n_source=300, n_pad=0, seed=length)
    x0 = (np.random.default_rng(length).standard_normal((b, 16)) * 0.1).astype(np.float32)
    yty = src.T @ src
    plan = tals._k3_plan(b, length, 16, False, N_SM)
    assert plan[0] == 1 and plan[1] == 16
    got = _k3_cluster_model(*_t(src, yty, idx, val, mask, x0), plan, cg_steps)
    want = _jax_cg(src, yty, idx, val, mask, x0, cg_steps, None)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------- K3's split design above rank 64
#
# Ranks 65-512 run the same split design with a lane owning ceil(k / 32)
# columns, rounded up to a class of 4, 8 or 16 (``ops.als.k3_cols``): the
# warp-mode length, the window, the exchanged partial and YtY's place (shared
# memory up to rank 128, L2 above) are functions of k mirrored from the
# source. The tests hold the mirror at ranks 65-512 and a model of the
# kernel's summation order (a lane's columns, the xor tree, a warp's block
# of entries, the warps in order, then the cluster's ranks) against JAX.

WIDE_K3_RANKS = [65, 100, 128, 129, 200, 256, 257, 512]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", WIDE_K3_RANKS)
def test_k3_wide_plan_covers_each_slot_once_in_rank_order(k, bf16):
    """At every rank-100 fit group, bench group and edge shape, each plan's
    units cover every slot of every row exactly once, a row's slices are
    contiguous and added in rank order, warp mode takes exactly the rows of
    at most ``k3_pack_l`` slots, and slices are whole chunks."""
    pack = tals.k3_pack_l(k)
    assert 4 <= pack <= 128 and pack % 4 == 0
    for b, length in WIDE_GROUPS + BENCH_GROUPS + K3_EDGES:
        plan = tals._k3_plan(b, length, k, bf16, N_SM)
        mode, c, slice_, resident = plan
        cover = np.zeros((b, length), dtype=np.int64)
        ranks: dict[int, list] = {}
        for cta, row, rank, start, end in tals.k3_units(b, length, plan):
            assert 0 <= start <= end <= length
            cover[row, start:end] += 1
            ranks.setdefault(row, []).append((rank, start, end))
            assert cta == (row // tals.K3_PACK_WARPS if mode == 0 else row * c + rank)
        assert (cover == 1).all()
        for got in ranks.values():
            assert [r for r, _, _ in got] == list(range(c if mode == 1 else 1))
            assert all(a[2] == z[1] for a, z in zip(got, got[1:]))
        if mode == 0:
            assert length <= pack and slice_ >= length and slice_ % 4 == 0 and resident
        else:
            assert length > pack and slice_ % 32 == 0 and -(-length // c) <= slice_ < -(-length // c) + 32


@pytest.mark.parametrize("bf16", [False, True])
def test_k3_wide_plans_fit_shared_memory_at_every_rank(bf16):
    """At every rank 65-512, every rank-100 fit group and every bench group
    (and a 20 000-slot row), with clusters of 16 and of the portable 8, the
    plan's shared bytes a CTA stay within the 227 KB a block may opt into;
    the rank-100 fit's longest row (1224 slots) is resident; a group of few
    rows is spread until it has a CTA an SM or K3_WIDE_SPREAD CTAs a row,
    and further only while its slice does not fit."""
    for k in range(65, 513):
        for b, length in WIDE_GROUPS + BENCH_GROUPS + [(1, 20000)]:
            for c_max in (8, 16):
                plan = tals._k3_plan(b, length, k, bf16, N_SM, c_max)
                mode, c, slice_, resident = plan
                assert c in tals.K3_CLUSTERS and c <= c_max
                assert tals.k3_smem(plan, k, bf16) <= tals.K3_SMEM < 227 * 1024 + 1
                if mode == 1 and c < c_max:
                    assert (b * c >= N_SM or c >= tals.K3_WIDE_SPREAD) and resident
                if mode == 1 and c > tals.K3_WIDE_SPREAD:
                    half = -(-(-(-length // (c // 2))) // 32) * 32
                    assert tals.k3_smem((1, c // 2, half, 1), k, bf16) > tals.K3_SMEM
    for k in (65, 100, 128):
        assert tals._k3_plan(1, 1224, k, bf16, N_SM)[3] == 1
    # above rank 128 YtY is read from L2 (no shared bytes), above 256 the CG vectors take shared memory
    assert tals.k3_smem((1, 1, 32, 1), 129, bf16) < tals.k3_smem((1, 1, 32, 1), 128, bf16)
    assert tals.k3_cols(64) == 2 and tals.k3_cols(65) == 4 and tals.k3_cols(257) == 16


def _xor_dot(a, b, nc):
    """``bucket_cg.cu dotv``: each lane's products over its columns l + 32 j
    in column order, then the warp's xor tree (lane 0 adds lane 16, then
    the pair 8 away, ...)."""
    k = a.shape[-1]
    prod = torch.nn.functional.pad(a * b, (0, 32 * nc - k)).reshape(*a.shape[:-1], nc, 32)
    d = prod[..., 0, :]
    for j in range(1, nc):
        d = d + prod[..., j, :]
    for o in (16, 8, 4, 2, 1):
        d = d[..., :o] + d[..., o:2 * o]
    return d[..., 0]


def _k3_split_model(src, yty, idx, val, mask, x0, plan, cg_steps, gather_dtype=None):
    """K3's split design as the card sums it, every row at once: each
    warp's block of entries (warp mode one block, cluster mode each rank's
    slice cut into K3_CTA_WARPS blocks) summed in entry order, the warps'
    partials added in warp order, then the ranks' in rank order; entry dots
    and CG dots over a lane's columns and the xor tree; YtY p with i
    ascending; then JAX's CG update."""
    def rnd(x):
        return tals._round(x, gather_dtype)

    mode, c, slice_, _ = plan
    b, length = idx.shape
    k = src.shape[1]
    nc = tals.k3_cols(k)
    warps, ranks = (1, 1) if mode == 0 else (tals.K3_CTA_WARPS, c)
    y = tals.gather_table(src, gather_dtype)[idx.long()].float() * mask[..., None]
    c1 = torch.where(mask, ALPHA * val, torch.zeros_like(val))
    w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
    slot = torch.arange(length)
    rank = slot // slice_ if mode == 1 else torch.zeros_like(slot)
    n = (torch.clamp((rank + 1) * slice_, max=length) - rank * slice_) if mode == 1 else torch.full_like(slot, length)
    per = -(-n // warps)
    unit = rank * warps + (slot - rank * slice_) // per if mode == 1 else torch.zeros_like(slot)
    pos = (slot - rank * slice_) % per if mode == 1 else slot

    def summed(term):  # term(slots) -> (B, len(slots), k), each unit's block in entry order, then warps, ranks
        acc = torch.zeros((b, ranks * warps, k))
        for p in range(int(pos.max()) + 1 if length else 0):
            at = (pos == p).nonzero()[:, 0]
            acc[:, unit[at]] += term(at)
        out = torch.zeros((b, k))
        for r in range(ranks):
            cta = torch.zeros((b, k))
            for wi in range(warps):
                cta = cta + acc[:, r * warps + wi]
            out = out + cta
        return out

    rn = REG * mask.sum(1, dtype=torch.float32)[:, None]
    b_vec = summed(lambda at: w[:, at, None] * y[:, at])
    diag = torch.clamp(torch.diagonal(yty)[None] + summed(lambda at: rnd(y[:, at] * y[:, at]) * rnd(c1[:, at, None]))
                       + rn, min=1e-12)

    def matvec(p):
        pr = rnd(p)
        s = summed(lambda at: y[:, at] * rnd(c1[:, at] * _xor_dot(y[:, at], pr[:, None], nc))[..., None])
        yp = torch.zeros_like(p)
        for i in range(k):
            yp = yp + p[:, i:i + 1] * yty[i]
        return yp + s + rn * p

    tiny = 1e-30
    x = x0
    r = b_vec - matvec(x)
    z = r / diag
    p = z
    rz = _xor_dot(r, z, nc)
    for _ in range(cg_steps):
        ap = matvec(p)
        step = rz / (_xor_dot(p, ap, nc) + tiny)
        x = x + step[:, None] * p
        r = r - step[:, None] * ap
        z = r / diag
        rz_new = _xor_dot(r, z, nc)
        beta = rz_new / (rz + tiny)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


@pytest.mark.parametrize("k", [65, 100, 129])
@pytest.mark.parametrize("b, length, gaps, c",
                         [(9, 30, False, None), (3, 300, False, 16), (2, 700, True, 16), (3, 300, False, 8),
                          (2, 700, True, 8), (1, 1224, False, None)],
                         ids=["warp-mode", "c16-short", "c16-gaps", "c8-short", "c8-gaps", "rank-100-longest"])
@pytest.mark.usefixtures("one_thread")
def test_k3_wide_model_matches_jax(b, length, gaps, c, k):
    """The split design's order at ranks 65, 100 and 129 (column classes of
    4 and 8, YtY from shared memory and from L2), 3 CG steps, a row of
    padding: under the plan the card takes (warp mode; the longest row of
    the rank-100 fit over K3_WIDE_SPREAD CTAs) and under slices forced over
    clusters of 16 and of 8 (ranks past the row's end holding no slot),
    within rtol 1e-5, atol 1e-6 of JAX's ``bucket_cg_body``, as the other
    K1-K3 parity tests (the order is the only difference)."""
    src, idx, val, mask = _k1_bucket(k, b, length, n_source=2 * k + 40, n_pad=1 if b > 1 else 0, gaps=gaps,
                                     seed=k + length)
    x0 = (np.random.default_rng(length).standard_normal((b, k)) * 0.1).astype(np.float32)
    yty = src.T @ src
    if c is None:
        plan = tals._k3_plan(b, length, k, False, N_SM)
        assert plan[0] == (0 if length <= tals.k3_pack_l(k) else 1)
    else:
        plan = (1, c, -(-(-(-length // c)) // 32) * 32, 1)
        assert length > tals.k3_pack_l(k) and plan[1] * (plan[2] - 32) < length <= plan[1] * plan[2]
    got = _k3_split_model(*_t(src, yty, idx, val, mask, x0), plan, 3)
    want = _jax_cg(src, yty, idx, val, mask, x0, 3, None)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)



def _f9_bucket(case: str):
    """The two buckets the K3-bf16 tolerance tests above use: "16x2152"
    (rank 50, where reversing a row's entries flips a bf16 rounding and
    moves the plain version past 5e-4) and "48x400" (a bench-shaped bucket
    of rows of 1 to 400 entries)."""
    if case == "16x2152":
        rng = np.random.default_rng(16 + 2152)
        b, length, n_source, k = 16, 2152, 20000, 50
        src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
        lens = rng.integers(length // 2, length + 1, size=b)
        lens[rng.random(b) < 0.25] = 0
        hi = 3.0
        x0 = (np.random.default_rng(16 + 2152).standard_normal((b, k)) * 0.1).astype(np.float32)
    else:
        rng = np.random.default_rng(31)
        b, length, n_source, k = 48, 400, 19991, 50
        src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
        lens = rng.integers(1, length + 1, size=b)
        lens[-4:] = 0
        lens[0] = length
        hi = 1.5
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, hi, size=(b, length)), 0).astype(np.float32)
    if case != "16x2152":
        x0 = (rng.standard_normal((b, k)) * 0.1).astype(np.float32)
    return torch.as_tensor(src), idx, val, mask, lens, torch.as_tensor(x0)


@pytest.mark.parametrize("case", ["16x2152", "48x400"])
def test_k3_bf16_row_limits_refuse_a_wrong_site(case, monkeypatch):
    """F9's check (``ops.als.bucket_cg_bf16_limits``): each row of K3-bf16
    is held to the effects of the bf16 roundings its float32 round-off could
    flip plus that round-off, at least 5e-4 of the group's max |x|. The
    plain version summed in another order (each row's entries rotated by
    half) passes it, on the long rows where it is more than 5e-4 away; a
    variant with one bf16 rounding site left out, and one with a single
    entry dropped from its shortest row, are refused."""
    src, idx, val, mask, lens, x0 = _f9_bucket(case)
    (b, length), k = idx.shape, src.shape[1]
    yty = tals.gramian(src)
    rows = torch.as_tensor(lens > 0)

    def solve(i, v, m=mask):
        return tals.bucket_cg_reference(src, yty, torch.as_tensor(i), torch.as_tensor(v), torch.as_tensor(m), x0,
                                        REG, ALPHA, 3, "bfloat16")

    want = solve(idx, val)
    limits = tals.bucket_cg_bf16_limits(src, yty, *_t(idx, val, mask), x0, REG, ALPHA, 3, rows=rows)

    def worst(got):
        return float(tals.bucket_cg_bf16_over(got[rows], want[rows], limits[rows]).max())

    rot_idx, rot_val = idx.copy(), val.copy()
    for r, n in enumerate(lens):
        rot_idx[r, :n], rot_val[r, :n] = np.roll(idx[r, :n], n // 2), np.roll(val[r, :n], n // 2)
    rotated = solve(rot_idx, rot_val)
    assert worst(rotated) <= 1.0
    if case == "16x2152":
        assert float((rotated - want)[rows].abs().max()) > 5e-4 * float(want[rows].abs().max())
    rounding = tals._round
    for site in ("y*y", "c1 of the diagonal", "p", "t"):
        monkeypatch.setattr(tals, "_round", _omitting(site, b, length, k))
        assert worst(solve(idx, val)) > 1.0, site
        monkeypatch.setattr(tals, "_round", rounding)
    short = int(np.argmin(np.where(lens > 0, lens, length + 1)))
    dropped = mask.copy()
    dropped[short, lens[short] - 1] = False
    assert worst(solve(idx, val, dropped)) > 1.0


def test_k3_plain_version_opens_its_rounding_sites():
    """The keywords F9's limits use (``bucket_cg_reference(sites=, pinned=,
    deltas=)``) leave the plain version's bits as they are, hand out each
    rounding site's value (p and t at every matvec), and a delta at one
    site changes that rounding alone: pinned to the plain roundings it
    gives the same bits, and one t of one row taken a bf16 step the other
    way moves that row only."""
    src, idx, val, mask, lens, x0 = _f9_bucket("48x400")
    yty = tals.gramian(src)
    call = (src, yty, *_t(idx, val, mask), x0, REG, ALPHA, 3, "bfloat16")
    want = tals.bucket_cg_reference(*call)
    sites = {}
    assert torch.equal(tals.bucket_cg_reference(*call, sites=sites), want)
    b, length = idx.shape
    assert sorted(sites) == [(m, kind) for m in range(4) for kind in ("p", "t")]
    assert all(tuple(v.shape) == ((b, src.shape[1]) if kind == "p" else (b, length)) for (m, kind), v in sites.items())
    pinned = {key: tals._round(v, "bfloat16") for key, v in sites.items()}
    assert torch.equal(tals.bucket_cg_reference(*call, pinned=pinned), want)
    delta = torch.zeros((b, length))
    delta[0, 5] = float(pinned[(2, "t")][0, 5]) * 2.0**-7
    moved = (tals.bucket_cg_reference(*call, deltas={(2, "t"): delta}) - want).abs().amax(dim=1)
    assert float(moved[0]) > 0 and not moved[1:].any()


def test_k3_bf16_limits_pass_every_further_order_and_refuse_faults(monkeypatch):
    """F9's limits on a small long-row bucket (rank 16, 6 rows of 300 to
    1500 entries): every one of 48 further random orders of the entries and
    columns (``ops.als._k3_reorders``, shuffles) stays within each row's
    limit, and a left-out rounding of t and a dropped entry are refused."""
    rng = np.random.default_rng(7)
    b, length, k, n_source = 6, 1500, 16, 4000
    src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32))
    lens = rng.integers(300, length + 1, size=b)
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 3.0, size=(b, length)), 0).astype(np.float32)
    x0 = torch.as_tensor((rng.standard_normal((b, k)) * 0.1).astype(np.float32))
    call = (src, tals.gramian(src), *_t(idx, val, mask), x0, REG, ALPHA, 3)
    want = tals.bucket_cg_bf16_reordered(*call)
    limits = tals.bucket_cg_bf16_limits(*call)
    orders = list(tals._k3_reorders(call[4], k, torch.Generator().manual_seed(3), 50))[2:]
    worst = max(float(tals.bucket_cg_bf16_over(tals.bucket_cg_bf16_reordered(*call, *o), want, limits).max())
                for o in orders)
    assert worst <= 1.0
    monkeypatch.setattr(tals, "_round", _omitting("t", b, length, k))
    assert float(tals.bucket_cg_bf16_over(tals.bucket_cg_reference(*call, "bfloat16"), want, limits).max()) > 1.0
    monkeypatch.undo()
    dropped = mask.copy()
    dropped[0, lens[0] - 1] = False
    got = tals.bucket_cg_reference(*call[:4], torch.as_tensor(dropped), *call[5:], "bfloat16")
    assert float(tals.bucket_cg_bf16_over(got, want, limits).max()) > 1.0


def test_k3_bf16_reorders_keep_the_padding():
    """The reorderings of F9's check permute each row's live entries among
    its live slots (reversed, then shuffled) and leave the padding where it
    is, gaps included, or permute the rank's columns."""
    mask = torch.tensor([[True, True, True, False], [True, False, True, True], [False] * 4])
    orders = list(tals._k3_reorders(mask, 5, torch.Generator().manual_seed(0), n=6))
    assert len(orders) == 6
    assert orders[0][0].tolist() == [[2, 1, 0, 3], [3, 1, 2, 0], [0, 1, 2, 3]] and orders[0][1] is None
    assert orders[1][0] is None and orders[1][1].tolist() == [4, 3, 2, 1, 0]
    for src_pos, cols in orders:
        if cols is not None:
            assert sorted(cols.tolist()) == list(range(5))
        if src_pos is None:
            continue
        for r in range(3):
            live = mask[r].nonzero().flatten().tolist()
            assert sorted(src_pos[r, live].tolist()) == live
            assert src_pos[r, ~mask[r]].tolist() == (~mask[r]).nonzero().flatten().tolist()


# ------------------------------------ F10: K3's tiled path's CG dot products
#
# Above rank 512 K3 runs its tiled kernel (one 128-thread CTA a row). Its CG
# dot products were summed by thread 0 alone over all k columns. Under bf16
# gathers that serial order's round-off flipped a bf16 rounding of p that
# F9's row limits do not cover: on the card, rank 513, a bucket of 256 rows
# of up to 16 entries, the worst row was 2.3 times over its limit. A model
# of the kernel's order (its products fused, as the card's fmaf) reproduces
# that number; with the dots summed as a block (each thread's columns, a
# warp's xor tree, the warps in order) the worst row is 0.11 of its limit.


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _k3_tiled_model(src, yty, idx, val, mask, x0, cg_steps, serial_dots):
    """K3-bf16's tiled kernel in its order (``bucket_cg.cu
    bucket_cg_wide_kernel``): b and the diagonal's sum entry by entry; each
    matvec's entry dot over a lane's columns then the xor tree, t back
    entry by entry, YtY p with i ascending; the CG dots by thread 0 in
    column order (``serial_dots``) or by the block."""
    b, length = idx.shape
    k = src.shape[1]
    y = src.to(torch.bfloat16).float()[idx.long()] * mask[..., None]
    c1 = torch.where(mask, ALPHA * val, torch.zeros_like(val))
    w = torch.where(mask, 1 + c1, torch.zeros_like(c1))
    rn = (REG * mask.sum(1, dtype=torch.float32))[:, None]
    b_vec, dg = torch.zeros(b, k), torch.zeros(b, k)
    for slot in range(length):
        b_vec = _fma(w[:, slot, None], y[:, slot], b_vec)
        dg = _fma(tals._round(y[:, slot] * y[:, slot], "bfloat16"), tals._round(c1[:, slot, None], "bfloat16"), dg)
    diag = torch.clamp(torch.diagonal(yty)[None] + dg + rn, min=1e-12)

    def tree(a, q, threads):  # each thread's columns by fused products, xor trees of 32, warps in order
        cols = -(-k // threads)
        pa, pq = (torch.nn.functional.pad(v, (0, threads * cols - k)).reshape(b, cols, threads) for v in (a, q))
        d = torch.zeros(b, threads)
        for j in range(cols):
            d = _fma(pa[:, j], pq[:, j], d)
        d = d.reshape(b, threads // 32, 32)
        for o in (16, 8, 4, 2, 1):
            d = d[..., :o] + d[..., o:2 * o]
        s = torch.zeros(b)
        for wi in range(threads // 32):
            s = s + d[:, wi, 0]
        return s

    def dot(a, q):
        if not serial_dots:
            return tree(a, q, 128)
        s = torch.zeros(b)
        for i in range(k):
            s = _fma(a[:, i], q[:, i], s)
        return s

    def matvec(v):
        out, pr = torch.zeros(b, k), tals._round(v, "bfloat16")
        for slot in range(length):
            t = tals._round(c1[:, slot] * tree(y[:, slot], pr, 32), "bfloat16")
            out = _fma(y[:, slot], t[:, None], out)
        yp = torch.zeros(b, k)
        for i in range(k):
            yp = _fma(v[:, i:i + 1], yty[i][None], yp)
        return (yp + out) + rn * v

    x = x0
    r = b_vec - matvec(x)
    z = r / diag
    p = z
    rz = dot(r, z)
    for _ in range(cg_steps):
        ap = matvec(p)
        step = rz / (dot(p, ap) + 1e-30)
        x = x + step[:, None] * p
        r = r - step[:, None] * ap
        z = r / diag
        rz_new = dot(r, z)
        beta = rz_new / (rz + 1e-30)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


@pytest.mark.usefixtures("one_thread")
def test_f10_k3_tiled_dots():
    """F10's input (the card test's 256 x 16 bucket at rank 513, the same
    numpy draws): the serial dots put a row 2.3 times over F9's limit, the
    block's dots keep every row under 0.2 of it."""
    k, b, length = 513, 256, 16
    rng = np.random.default_rng(k + b)
    n_source = 2 * k + 40
    src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
    lens = rng.integers(0, length + 1, size=b)
    lens[0], lens[-1] = length, 0
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 3.0, size=(b, length)), 0).astype(np.float32)
    x0 = (rng.standard_normal((b, k)) * 0.1).astype(np.float32)
    src_t, idx_t, val_t, mask_t, x0_t = _t(src, idx, val, mask, x0)
    yty = tals.gramian(src_t)
    call = (src_t, yty, idx_t, val_t, mask_t, x0_t)
    want = tals.bucket_cg_reference(*call, REG, ALPHA, 3, "bfloat16")
    limits = tals.bucket_cg_bf16_limits(*call, REG, ALPHA, 3)
    serial = tals.bucket_cg_bf16_over(_k3_tiled_model(*call, 3, serial_dots=True), want, limits)
    block = tals.bucket_cg_bf16_over(_k3_tiled_model(*call, 3, serial_dots=False), want, limits)
    assert float(serial.max()) > 2.0
    assert float(block.max()) < 0.2
