"""The port's HTTP plane against the JAX package's, both served on port 0.

The two servers front services over the same factor tables (seeded numpy)
and the same synthetic tables. Routes are held to the port's own service;
the error bodies (400, 404, 429, 503) are held byte for byte to the JAX
server's answer to the same request. Every network wait has its own
timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from albedo_tpu.datasets import synthetic_tables as j_tables
from albedo_tpu.models.als import ALSModel as JaxModel
from albedo_tpu.serving import RecommendationService as JaxService
from albedo_tpu.serving import serve as jax_serve
from albedo_tpu.utils import faults as jax_faults
from albedo_tpu_torch.datasets import synthetic_tables
from albedo_tpu_torch.models.als import ALSModel
from albedo_tpu_torch.serving import RecommendationService, serve
from albedo_tpu_torch.utils import faults

RANK = 8
TIMEOUT = 30


@pytest.fixture(autouse=True)
def _port_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def world():
    tables = synthetic_tables(n_users=120, n_items=90, mean_stars=8, seed=5)
    matrix = tables.star_matrix(policy="off")
    rng = np.random.default_rng(4)
    uf = (rng.standard_normal((matrix.n_users, RANK)) / np.sqrt(RANK)).astype(np.float32)
    vf = (rng.standard_normal((matrix.n_items, RANK)) / np.sqrt(RANK)).astype(np.float32)
    model = ALSModel.from_arrays({"user_factors": uf, "item_factors": vf, "rank": RANK}, device="cpu")
    j = j_tables(n_users=120, n_items=90, mean_stars=8, seed=5)
    return tables, matrix, model, j, j.star_matrix(policy="off"), JaxModel(uf, vf, RANK)


@pytest.fixture(scope="module")
def servers(world):
    tables, matrix, model, j, j_matrix, j_model = world
    svc = RecommendationService(model, matrix, repo_info=tables.repo_info, user_info=tables.user_info,
                                cache_ttl=30.0)
    jsvc = JaxService(j_model, j_matrix, repo_info=j.repo_info, user_info=j.user_info, cache_ttl=30.0)
    with serve(svc, port=0) as handle, jax_serve(jsvc, port=0) as jhandle:
        yield (f"http://127.0.0.1:{handle.server_address[1]}",
               f"http://127.0.0.1:{jhandle.server_address[1]}", svc)


def _call(url: str, method: str = "GET"):
    """(status, headers, body bytes) of one request."""
    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_routes_answer(world, servers):
    _, matrix, _, _, _, _ = world
    url, jurl, svc = servers
    uid = int(matrix.user_ids[3])
    for k in (5, 500):
        status, headers, body = _call(f"{url}/recommend/{uid}?k={k}")
        assert status == 200 and headers["Content-Type"] == "application/json"
        got = json.loads(body)
        assert got["items"] == svc.recommend(uid, k=k)["items"] and got["generation"] == 1
    status, _, body = _call(f"{url}/recommend/{uid}?k=30&exclude_seen=0&deadline_ms=5000")
    assert status == 200 and json.loads(body)["items"] == svc.recommend(uid, k=30, exclude_seen=False)["items"]
    for path in ("/admin/repos?q=repo&limit=3", "/admin/repos", "/admin/users?limit=4", "/healthz", "/"):
        status, _, body = _call(url + path)
        jstatus, _, jbody = _call(jurl + path)
        assert status == jstatus == 200 and body == jbody, path
    status, headers, body = _call(f"{url}/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    assert "albedo_requests_total{" in body.decode() and "albedo_admission_limit 256" in body.decode()
    status, _, body = _call(f"{url}/healthz/ready")
    report = json.loads(body)
    assert status == 200 and report["ready"] and report["generation"] == 1
    assert report["batcher"]["active"] and report["cache"]["maxsize"] == 4096


@pytest.mark.parametrize("method,path", [
    ("GET", "/recommend/abc"),
    ("GET", "/recommend/{uid}?k=x"),
    ("GET", "/recommend/{uid}?deadline_ms=soon"),
    ("GET", "/admin/repos?limit=zz"),
    ("GET", "/nope"),
    ("GET", "/recommend/1/2"),
    ("GET", "/healthz/readiness"),
    ("GET", "/recommend/987654321"),
    ("POST", "/admin/reload"),
    ("POST", "/admin/reload?artifact=../etc/passwd"),
    ("POST", "/cache/invalidate?user_id=q"),
    ("POST", "/nope"),
])
def test_error_bodies_equal_jax(world, servers, method, path):
    uid = int(world[1].user_ids[0])
    url, jurl, _ = servers
    status, _, body = _call(url + path.format(uid=uid), method)
    jstatus, _, jbody = _call(jurl + path.format(uid=uid), method)
    assert status in (400, 404, 503)
    assert (status, body) == (jstatus, jbody)


def test_429_body_and_retry_after_equal_jax(world, servers):
    """A forced admission shed (the ``serving.admit`` fault site, armed in
    each package): 429, the same body with its brownout tier, and a
    Retry-After header."""
    uid = int(world[1].user_ids[5])
    url, jurl, _ = servers
    faults.arm("serving.admit", "error", at=1)
    jax_faults.arm("serving.admit", "error", at=1)
    status, headers, body = _call(f"{url}/recommend/{uid}?k=7")
    jstatus, jheaders, jbody = _call(f"{jurl}/recommend/{uid}?k=7")
    assert status == jstatus == 429 and body == jbody
    assert json.loads(body)["brownout"] == {"level": 0, "tier": "full"}
    assert headers["Retry-After"] == jheaders["Retry-After"] == "1"


def test_cache_invalidation(world, servers):
    uid = int(world[1].user_ids[7])
    url, _, svc = servers
    for _ in range(2):
        assert _call(f"{url}/recommend/{uid}?k=4")[0] == 200
    assert svc.metrics.cache_hits.value() >= 1
    status, _, body = _call(f"{url}/cache/invalidate?user_id={uid}", "POST")
    assert status == 200 and json.loads(body)["invalidated"] >= 1
    status, _, body = _call(f"{url}/cache/invalidate", "POST")
    assert status == 200 and "invalidated" in json.loads(body)


def test_shutdown_leaves_no_threads(world):
    tables, matrix, model, _, _, _ = world
    before = set(threading.enumerate())  # the module's servers stay up
    svc = RecommendationService(model, matrix, repo_info=tables.repo_info)
    with serve(svc, port=0) as handle:
        url = f"http://127.0.0.1:{handle.server_address[1]}"
        done = []
        threads = [threading.Thread(target=lambda u=u: done.append(_call(f"{url}/recommend/{u}?k=3")[0]))
                   for u in matrix.user_ids[:8]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert done == [200] * 8
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        alive = [t.name for t in set(threading.enumerate()) - before if t.name.startswith("albedo-")]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, alive
    handle.shutdown()  # idempotent
