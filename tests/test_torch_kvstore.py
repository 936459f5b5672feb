"""The port's KV object store held against the JAX package's, on the CPU.

Mirrors ``tests/test_kvstore.py``: the entry envelope (byte for byte the
reference's, bfloat16 and shard dicts included, and each package reads
the other's entries and directories), the local-dir and S3 backends, the
store's chains, corruption, LRU budget and loud write errors, the
directory's store-held half, the plane's store fetch, and the flows
through engines and schedulers: write-through then a fleet bounce that
admits warm from the store (dense and paged, each package reading the
other's directory), session parking restored on another engine, a park
whose write fails, the store vanishing mid-fetch, a failing
write-through, tier evictions sinking to the store, a chain evicted from
every tier, the router's store hint and ring feeds, the journal header's
store section, and the namespace fence. Every scenario runs the same op
stream through each package with the same fp32 weights under
``attn_impl="reference"``; tokens, counters and manifests must be equal.

The single-replica worlds (two engines, each with its own plane and
scheduler; the store is attached per scenario) are built once per module
and package and shared by the scenarios, each on prompts of its own.
"""
import dataclasses
import os
import queue
import shutil
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
import ray_lightning_tpu.obs.journal as j_journal
import ray_lightning_tpu.serve.engine as j_engine
import ray_lightning_tpu.serve.kvfleet as j_kvfleet
import ray_lightning_tpu.serve.kvstore as j_kvstore
import ray_lightning_tpu.serve.router as j_router
import ray_lightning_tpu.serve.scheduler as j_sched
from ray_lightning_tpu.obs.events import EventLog as JEventLog
from ray_lightning_tpu.obs.registry import MetricsRegistry as JRegistry
import ray_lightning_tpu_torch.obs.journal as t_journal
import ray_lightning_tpu_torch.serve.engine as t_engine
import ray_lightning_tpu_torch.serve.kvfleet as t_kvfleet
import ray_lightning_tpu_torch.serve.kvstore as t_kvstore
import ray_lightning_tpu_torch.serve.router as t_router
import ray_lightning_tpu_torch.serve.scheduler as t_sched
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.obs.events import EventLog as TEventLog
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry as TRegistry

JAX_CFG = jgpt.GPTConfig(
    vocab_size=97, n_layer=2, n_head=4, d_model=32, max_seq=64,
    attn_impl="reference", compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))
BLOCK = 4

KINDS = {
    "dense": dict(num_slots=3, max_seq=64, prefill_buckets=[16],
                  prefill_chunk=4, prefix_blocks=16, prefix_block=BLOCK,
                  decode_fold=2),
    "paged": dict(num_slots=3, max_seq=64, prefill_buckets=[16],
                  prefill_chunk=4, kv_page=BLOCK, kv_pages=48, decode_fold=2),
}

#: The store counters a scenario compares.
STORE_KEYS = ("hits", "misses", "writes", "write_errors", "bytes_written",
              "bytes_read", "evictions", "corrupt")
#: The plane's store-fetch counters.
PLANE_KEYS = ("store_fetches", "store_fetch_blocks", "store_fetch_bytes",
              "store_fetch_misses", "imports")


def _numpy_tree(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        k: (
            {n: 0.1 * rng.standard_normal(s).astype(np.float32)
             for n, s in v.items()}
            if isinstance(v, dict)
            else 0.1 * rng.standard_normal(v).astype(np.float32)
        )
        for k, v in tgpt.param_shapes(cfg).items()
    }


_TREE = _numpy_tree(CFG)

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", sched=j_sched, kvfleet=j_kvfleet, kvstore=j_kvstore,
        journal=j_journal, router=j_router, EventLog=JEventLog,
        Registry=JRegistry,
        engine=lambda params, **kw: j_engine.DecodeEngine(params, JAX_CFG,
                                                          **kw),
    ),
    "torch": types.SimpleNamespace(
        name="torch", sched=t_sched, kvfleet=t_kvfleet, kvstore=t_kvstore,
        journal=t_journal, router=t_router, EventLog=TEventLog,
        Registry=TRegistry,
        engine=lambda params, **kw: t_engine.DecodeEngine(
            params, CFG, device="cpu", **kw),
    ),
}


@pytest.fixture(scope="module")
def params():
    return {
        "jax": jax.tree_util.tree_map(jnp.asarray, _TREE),
        "torch": params_from_jax(_TREE, CFG, "cpu"),
    }


def _both(scenario, *args):
    """Run ``scenario(ns, *args)`` against each package; the records must
    be equal. Returns the port's record."""
    got = {name: scenario(ns, *args) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _np(x):
    """A payload as a numpy array (torch tensors through float32 when they
    are bfloat16, which numpy lacks)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).astype(np.float32) if x.dtype == ml_dtypes.bfloat16 \
        else np.asarray(x)


def _hexd(i):
    return f"{i:02x}" * 16


def _blk(i, shape=(2, 4)):
    return np.full(shape, float(i), np.float32)


def _fake_blocks(n):
    return [(_hexd(i), _blk(i), _blk(i + 100)) for i in range(n)]


def _stats(store):
    s = store.stats()
    return {k: s[k] for k in STORE_KEYS} | {
        "recent_writes": s["recent_writes"],
        "recent_dropped": s["recent_dropped"],
        "manifest": sorted(store.manifest()),
    }


# ---------------------------------------------------------------------------
# The envelope and the backends (tests/test_kvstore.py:151-238)
# ---------------------------------------------------------------------------
def test_entries_are_byte_for_byte_the_jax_packages():
    """The same digest and block make the same bytes in both packages
    (fp32, bf16, fp16 and a shard dict), and each decodes the other's."""
    g = np.random.default_rng(3)
    a = g.standard_normal((2, 1, 4, 2, 8)).astype(np.float32)
    b = g.standard_normal((2, 1, 4, 2, 8)).astype(np.float32)
    for np_dt, t_dt in ((np.float32, torch.float32),
                        (ml_dtypes.bfloat16, torch.bfloat16),
                        (np.float16, torch.float16)):
        j = j_kvstore.encode_entry(_hexd(7), a.astype(np_dt), b.astype(np_dt))
        t = t_kvstore.encode_entry(_hexd(7), torch.from_numpy(a).to(t_dt),
                                   torch.from_numpy(b).to(t_dt))
        assert j == t, np_dt
        key, k2, v2 = t_kvstore.decode_entry(j)
        assert key == _hexd(7) and k2.dtype == t_dt
        assert torch.equal(k2, torch.from_numpy(a).to(t_dt))
        key, k3, _ = j_kvstore.decode_entry(t)
        assert np.array_equal(_np(k3), _np(torch.from_numpy(a).to(t_dt)))
    shards = {((0, 1), (0, 4)): a[:1, 0, 0, 0, :4],
              ((1, 2), (0, 4)): b[:1, 0, 0, 0, :4].astype(ml_dtypes.bfloat16)}
    t_shards = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.bfloat16 if v.dtype == ml_dtypes.bfloat16 else torch.float32)
        for k, v in shards.items()}
    j = j_kvstore.encode_entry(_hexd(3), shards, _blk(9))
    assert t_kvstore.encode_entry(_hexd(3), t_shards,
                                  torch.from_numpy(_blk(9))) == j
    _, k2, v2 = t_kvstore.decode_entry(j)
    assert set(k2) == set(shards)
    for key in shards:
        assert torch.equal(k2[key], t_shards[key])


def _damage(ns):
    good = ns.kvstore.encode_entry(_hexd(1), _blk(1), _blk(2))
    flipped = bytearray(good)
    flipped[-1] ^= 0xFF
    return [ns.kvstore.decode_entry(x) is None for x in (
        good, b"", b"not an entry at all", good[:-3],
        b"XXXXXXXX" + good[8:], bytes(flipped))]


def _backend(ns, root):
    os.makedirs(root)
    with open(os.path.join(root, _hexd(5) + ".kv.999.tmp"), "wb") as f:
        f.write(b"torn")
    be = ns.kvstore.LocalDirBackend(root)
    rec = [sorted(os.listdir(root)), be.entries(), be.put(_hexd(1), b"pay"),
           be.get(_hexd(1)), be.get(_hexd(2)),
           [(k, n) for k, n, _ in be.entries()]]
    be.delete(_hexd(1))
    be.delete(_hexd(1))
    return rec + [be.entries()]


def _s3(ns):
    be = ns.kvstore.open_backend("s3://warm-pages/fleet/a")
    rec = [type(be).__name__, be.bucket, be.prefix]
    for op in (lambda: be.put("k", b"x"), lambda: be.get("k"),
               lambda: be.entries(), lambda: ns.kvstore.S3ObjectBackend(
                   "s3://")):
        try:
            op()
        except (NotImplementedError, ValueError) as exc:
            rec.append((type(exc).__name__, "interface-only" in str(exc)
                        or "names no bucket" in str(exc)))
    store = ns.kvstore.FleetKVStore("s3://warm-pages/fleet", budget_mb=16.0)
    rec += [store.put_block(_hexd(1), _blk(1), _blk(2)), store.write_errors,
            store.get_chain([_hexd(1)]), store.manifest(),
            store.entry_count()]
    return rec


def test_envelope_damage_backends_and_s3_match_jax(tmp_path):
    assert _both(_damage) == [False] + [True] * 5
    rec = _both(lambda ns: _backend(ns, str(tmp_path / ns.name)))
    assert rec[0] == [] and rec[2] == 3 and rec[3] == b"pay"
    assert rec[-1] == []
    rec = _both(_s3)
    assert rec[:3] == ["S3ObjectBackend", "warm-pages", "fleet/a"]
    assert rec[3:7] == [("NotImplementedError", True)] * 3 + [
        ("ValueError", True)]
    assert rec[7:] == [False, 1, ([], [_hexd(1)]), [], 0]


# ---------------------------------------------------------------------------
# FleetKVStore (tests/test_kvstore.py:239-333)
# ---------------------------------------------------------------------------
def _chain(ns, root):
    store = ns.kvstore.FleetKVStore(root)
    rec = [store.put_blocks(_fake_blocks(3))]
    blocks, missing = store.get_chain([_hexd(0), _hexd(1), _hexd(9),
                                       _hexd(2)])
    rec += [[b[0] for b in blocks], missing, _np(blocks[1][1]).tolist(),
            store.contains(_hexd(2)), store.contains(_hexd(9)),
            store.stats()["backend"], _stats(store)]
    base = os.stat(store.backend._path(_hexd(0))).st_mtime
    for i, age in ((2, 300), (0, 200), (1, 100)):
        t = base - age
        os.utime(store.backend._path(_hexd(i)), (t, t))
    return rec + [store.manifest()]


def _corrupt(ns, root):
    store = ns.kvstore.FleetKVStore(root)
    store.put_blocks(_fake_blocks(2))
    path = store.backend._path(_hexd(0))
    with open(path, "wb") as f:
        f.write(b"rotted on disk")
    blocks, missing = store.get_chain([_hexd(0), _hexd(1)])
    rec = [blocks, missing, os.path.exists(path), _stats(store)]
    blocks, missing = store.get_chain([_hexd(1)])
    return rec + [len(blocks), missing]


def _budget(ns, root):
    store = ns.kvstore.FleetKVStore(root)
    store.put_blocks(_fake_blocks(4))
    per = store.total_bytes() // 4
    base = os.stat(store.backend._path(_hexd(0))).st_mtime
    for i, age in ((1, 400), (2, 300), (3, 200), (0, 100)):
        t = base - age
        os.utime(store.backend._path(_hexd(i)), (t, t))
    bounded = ns.kvstore.FleetKVStore(
        root, budget_mb=(per * 2 + per // 2) / (1 << 20))
    rec = [per, bounded.evictions, sorted(bounded.manifest()),
           sorted(bounded.stats()["recent_dropped"]),
           bounded.total_bytes() <= bounded.budget_bytes]
    bounded.put_blocks([(_hexd(7), _blk(7), _blk(8))])
    return rec + [bounded.entry_count(),
                  bounded.total_bytes() <= bounded.budget_bytes]


def _write_errors(ns, root, monkeypatch):
    log = ns.EventLog()
    store = ns.kvstore.FleetKVStore(root, events=log)

    def _die(key, data):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(store.backend, "put", _die)
    rec = [store.put_block(_hexd(1), _blk(1), _blk(2)),
           store.put_blocks(_fake_blocks(2)), _stats(store)]
    evs = log.tail(name="kvstore_write_error")
    return rec + [len(evs), "OSError" in str(evs[-1])]


def test_store_chains_corruption_budget_and_errors_match_jax(tmp_path,
                                                             monkeypatch):
    rec = _both(lambda ns: _chain(ns, str(tmp_path / "chain" / ns.name)))
    assert rec[:3] == [3, [_hexd(0), _hexd(1)], [_hexd(9), _hexd(2)]]
    assert rec[-1] == [_hexd(2), _hexd(0), _hexd(1)]
    rec = _both(lambda ns: _corrupt(ns, str(tmp_path / "bad" / ns.name)))
    assert rec[0] == [] and rec[2] is False and rec[3]["corrupt"] == 1
    assert rec[-2:] == [1, []]
    rec = _both(lambda ns: _budget(ns, str(tmp_path / "gc" / ns.name)))
    assert rec[1] == 2 and rec[2] == sorted([_hexd(0), _hexd(3)])
    assert rec[-2:] == [2, True]
    rec = _both(lambda ns: _write_errors(ns, str(tmp_path / "err" / ns.name),
                                         monkeypatch))
    assert rec[:2] == [False, 0] and rec[2]["write_errors"] == 3
    assert rec[-2:] == [3, True]
    assert t_kvstore.kvstore_config_from_header({
        "kvstore": {"dir": "/x", "budget_mb": 64.0, "writethrough": True,
                    "secret": 1}}) == j_kvstore.kvstore_config_from_header({
        "kvstore": {"dir": "/x", "budget_mb": 64.0, "writethrough": True,
                    "secret": 1}}) == {"dir": "/x", "budget_mb": 64.0,
                                       "writethrough": True}
    assert t_kvstore.kvstore_config_from_header(None) == {}


def _cross(ns, other, root):
    """``other`` writes a directory (fp32 and bf16 blocks); ``ns`` reads
    it, and its manifest."""
    g = np.random.default_rng(5)
    a = g.standard_normal((2, 1, 4, 2, 8)).astype(np.float32)
    if other.name == "jax":
        blocks = [(_hexd(1), a, a), (_hexd(2), a.astype(ml_dtypes.bfloat16),
                                     a.astype(ml_dtypes.bfloat16))]
    else:
        ta = torch.from_numpy(a)
        blocks = [(_hexd(1), ta, ta), (_hexd(2), ta.to(torch.bfloat16),
                                       ta.to(torch.bfloat16))]
    other.kvstore.FleetKVStore(root, namespace="cafe0123cafe0123"
                               ).put_blocks(blocks)
    reader = ns.kvstore.FleetKVStore(root, namespace="cafe0123cafe0123")
    got, missing = reader.get_chain([_hexd(1), _hexd(2)])
    files = {n: open(os.path.join(root, n), "rb").read()
             for n in sorted(os.listdir(root))}
    return ([h for h, _, _ in got], missing, sorted(reader.manifest()),
            [np.array_equal(_np(k), _np(a) if h == _hexd(1) else _np(
                torch.from_numpy(a).to(torch.bfloat16))) for h, k, _ in got],
            files)


def test_each_package_reads_the_others_directory(tmp_path):
    j_reads_t = _cross(PKGS["jax"], PKGS["torch"], str(tmp_path / "t"))
    t_reads_j = _cross(PKGS["torch"], PKGS["jax"], str(tmp_path / "j"))
    for rec in (j_reads_t, t_reads_j):
        assert rec[0] == [_hexd(1), _hexd(2)] and rec[1] == []
        assert rec[2] == [_hexd(1), _hexd(2)] and rec[3] == [True, True]
    assert j_reads_t[4] == t_reads_j[4]  # the files, byte for byte


# ---------------------------------------------------------------------------
# The directory's store half, the plane's store fetch (:335-420)
# ---------------------------------------------------------------------------
def _directory(ns):
    d = ns.kvfleet.FleetKVDirectory(capacity=16)
    digs = [bytes([i]) * 16 for i in range(4)]
    d.observe(digs, 1)
    d.observe_store(digs[:3])
    rec = [d.forget_replica(1), d.chain(digs), d.store_chain(digs),
           d.forget_store_digests([digs[1], digs[1]]), d.store_chain(digs),
           d.store_holds(digs[2])]
    for i in range(40):
        d.observe_store([bytes([100 + i]) * 16])
    return rec + [d.store_entries(), d.store_holds(digs[0])]


def _plane_store(ns, root):
    store = ns.kvstore.FleetKVStore(root)
    store.put_blocks(_fake_blocks(3))
    plane = ns.kvfleet.KVFleetPlane(index=0, inbox=queue.Queue(),
                                    block_bytes=64, min_poll_s=0.0,
                                    store=store)
    digs = [_hexd(i) for i in range(3)]
    imported = []
    rec = [plane.request_store_fetch("r1", []),
           plane.request_store_fetch("r1", digs),
           plane.request_store_fetch("r1", digs)]
    out = plane.service(None, lambda b: imported.append([h for h, _, _ in b])
                        or len(b))
    rec += [out, imported, {k: plane.stats()[k] for k in PLANE_KEYS}]
    bare = ns.kvfleet.KVFleetPlane(index=0, inbox=queue.Queue(),
                                   min_poll_s=0.0)
    rec.append(bare.request_store_fetch("r2", digs))
    # An empty chain head, then the whole directory gone mid-fetch.
    rec.append(plane.request_store_fetch("r3", [_hexd(9)]))
    rec.append(plane.service(None, len))
    rec.append(plane.request_store_fetch("r4", [_hexd(0)]))
    shutil.rmtree(root)
    rec.append(plane.service(None, len))
    return rec + [{k: plane.stats()[k] for k in PLANE_KEYS}]


def test_directory_store_half_and_plane_store_fetch_match_jax(tmp_path):
    rec = _both(_directory)
    assert rec[:3] == [4, (None, 0), 3] and rec[4] == 1
    rec = _both(lambda ns: _plane_store(ns, str(tmp_path / ns.name)))
    assert rec[:3] == [False, True, False]
    assert rec[3]["store_fetched"] == ["r1"]
    assert rec[3]["fetched"] == [("r1", 3)]
    assert rec[6] is False
    assert rec[8]["failed"] == [("r3", "store_miss")]
    assert rec[10]["failed"] == [("r4", "store_miss")]
    assert rec[-1]["store_fetch_misses"] == 2


# ---------------------------------------------------------------------------
# Flows through engines and schedulers (:422-628)
# ---------------------------------------------------------------------------
class _Solo:
    """One engine with its own plane and scheduler; the store is attached
    per scenario (:meth:`attach`)."""

    def __init__(self, ns, params, kind):
        self.engine = ns.engine(params, **KINDS[kind])
        inbox = queue.Queue()
        self.plane = ns.kvfleet.KVFleetPlane(
            index=0, inbox=inbox, peers={0: inbox},
            block_bytes=self.engine.prefix_block_nbytes, min_poll_s=0.0)
        self.sched = ns.sched.Scheduler(self.engine, kvfleet=self.plane)

    def attach(self, store, writethrough=False, events=None):
        self.plane.store = store
        self.sched.kvstore = store
        self.sched.kvstore_writethrough = writethrough
        self.sched.events = events

    def run(self, prompt, sp, rid, hint=None):
        self.sched.submit(prompt, sp, request_id=rid, kv_hint=hint)
        evs = self.sched.run_until_idle()
        return [e.token for e in evs if e.request_id == rid
                and e.token is not None]

    def counters(self):
        s = self.plane.stats()
        return {**{k: s[k] for k in PLANE_KEYS},
                "handoff_imports": self.engine.prefix_handoff_imports,
                "hit_tokens": self.engine.prefix_hit_tokens}


_WORLDS = {}


@pytest.fixture(scope="module")
def worlds(params):
    """(package, kind) -> two single-replica worlds (A, B)."""

    def get(pkg, kind):
        key = (pkg, kind)
        if key not in _WORLDS:
            _WORLDS[key] = [_Solo(PKGS[pkg], params[pkg], kind)
                            for _ in range(2)]
        return _WORLDS[key]

    yield get
    for pair in _WORLDS.values():
        for w in pair:
            w.attach(None)
    _WORLDS.clear()


def _sp(ns, n=6, seed=0):
    return ns.sched.SamplingParams(max_new_tokens=n, seed=seed)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size,
                                                size=n).tolist()


def _digests(prompt):
    return [d.hex() for d in t_router.prompt_block_digests(prompt, BLOCK)]


def _store_hint(prompt, run=None):
    digs = _digests(prompt)[:run]
    return {"peer": None, "store": True, "digests": digs,
            "blocks": len(digs)}


def _solo_tokens(params, prompt, n):
    return tgpt.gpt_generate(params["torch"], CFG, [prompt], n,
                             device="cpu")[0].tolist()[len(prompt):]


def _delta(a, b):
    return {k: b[k] - a[k] for k in a}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_fleet_bounce_warm_starts_from_the_store(params, worlds, tmp_path,
                                                 kind):
    """World A writes its prefill through to a store directory; world B,
    a fresh fleet on the same directory, seeds from the manifest and
    admits the revisit warm through a store fetch. Each package's B reads
    the directory the OTHER package's A wrote."""
    prompt = _prompt(31, 14)
    roots = {n: str(tmp_path / n) for n in PKGS}

    def write(ns):
        a, _ = worlds(ns.name, kind)
        store = ns.kvstore.FleetKVStore(roots[ns.name])
        a.attach(store, writethrough=True)
        try:
            toks = a.run(prompt, _sp(ns), "warm")
        finally:
            a.attach(None)
        return toks, _stats(store)

    def bounce(ns):
        _, b = worlds(ns.name, kind)
        other = "torch" if ns.name == "jax" else "jax"
        store = ns.kvstore.FleetKVStore(roots[other])
        manifest = sorted(store.manifest())
        b.attach(store)
        try:
            before = b.counters()
            toks = b.run(prompt, _sp(ns), "bounce", _store_hint(prompt))
            after = b.counters()
        finally:
            b.attach(None)
        return toks, manifest, _delta(before, after), store.hits

    warm, wstats = _both(write)
    toks, manifest, d, hits = _both(bounce)
    assert warm == toks == _solo_tokens(params, prompt, 6)
    assert wstats["writes"] >= 3
    assert set(_digests(prompt)) <= set(manifest)
    assert d["store_fetches"] == 1 and d["store_fetch_misses"] == 0
    assert d["store_fetch_blocks"] == 3 and d["hit_tokens"] == 12
    assert hits == 3


def test_park_restores_on_another_engine(params, worlds, tmp_path):
    """Turn 1 on A, parked (export, store, free); turn 2 on B restores
    the chain through the store and emits the uninterrupted tokens."""
    p1 = _prompt(37, 13)

    def scenario(ns):
        a, b = worlds(ns.name, "dense")
        store = ns.kvstore.FleetKVStore(str(tmp_path / ns.name))
        a.attach(store)
        b.attach(store)
        try:
            t1 = a.run(p1, _sp(ns, 6), "t1")
            convo = p1 + t1
            a.sched.request_park(convo, request_id="t1")
            pending = a.sched.has_work()
            a.sched.step()
            rec = a.sched.park_result(timeout=5.0)
            left = a.engine.cached_prefix_blocks(convo)
            p2 = convo + _prompt(38, 5)
            run = 0
            for h in _digests(p2):
                if not store.contains(h):
                    break
                run += 1
            before = b.counters()
            t2 = b.run(p2, _sp(ns, 6, seed=1), "t2", _store_hint(p2, run))
            return (t1, t2, pending, rec, left, run,
                    _delta(before, b.counters()))
        finally:
            a.attach(None)
            b.attach(None)

    t1, t2, pending, rec, left, run, d = _both(scenario)
    assert t1 == _solo_tokens(params, p1, 6)
    assert t2 == _solo_tokens(params, p1 + t1 + _prompt(38, 5), 6)
    # The prompt's three full blocks are cached (the generated tokens'
    # block never entered the pool).
    assert pending and rec["stored"] == rec["blocks"] == rec["freed"] == 3
    assert left == 0 and run == 3
    assert d["store_fetches"] == 1 and d["hit_tokens"] > 0


def test_park_partial_write_keeps_pages(worlds, tmp_path, monkeypatch):
    """A park whose store write fails frees nothing: the pages stay warm
    and the loss is loud (write errors, a warn event)."""
    p1 = _prompt(41, 13)

    def scenario(ns):
        a, _ = worlds(ns.name, "dense")
        log = ns.EventLog()
        store = ns.kvstore.FleetKVStore(str(tmp_path / ns.name), events=log)
        a.attach(store, events=log)
        try:
            convo = p1 + a.run(p1, _sp(ns, 4), "t1")

            def _die(key, data):
                raise OSError(28, "No space left on device")

            monkeypatch.setattr(store.backend, "put", _die)
            a.sched.request_park(convo, request_id="t1")
            a.sched.step()
            rec = a.sched.park_result(timeout=5.0)
            evs = log.tail(name="kv_park")
            return (rec["blocks"], rec["stored"], rec["freed"],
                    a.engine.cached_prefix_blocks(convo) > 0,
                    store.write_errors, evs[-1]["level"])
        finally:
            a.attach(None)

    blocks, stored, freed, warm, errors, level = _both(scenario)
    assert blocks > 0 and stored == freed == 0 and warm
    assert errors >= blocks and level == "warn"


def test_store_vanishing_and_failing_writethrough_stay_exact(
        params, worlds, tmp_path, monkeypatch):
    """A store hint whose directory is gone prefills cold (a counted
    miss); a write-through whose every put fails never blocks the
    request. Both with the solo run's tokens."""
    gone_p, wt_p = _prompt(43, 14), _prompt(47, 14)

    def scenario(ns):
        a, _ = worlds(ns.name, "dense")
        root = str(tmp_path / "gone" / ns.name)
        a.attach(ns.kvstore.FleetKVStore(root))
        try:
            shutil.rmtree(root)
            before = a.counters()
            gone = a.run(gone_p, _sp(ns), "r", _store_hint(gone_p))
            d = _delta(before, a.counters())
            store = ns.kvstore.FleetKVStore(str(tmp_path / "ro" / ns.name))

            def _die(key, data):
                raise OSError(30, "Read-only file system")

            monkeypatch.setattr(store.backend, "put", _die)
            a.attach(store, writethrough=True)
            wt = a.run(wt_p, _sp(ns), "w")
            return gone, d, wt, store.write_errors > 0, store.writes
        finally:
            a.attach(None)

    gone, d, wt, errored, writes = _both(scenario)
    assert gone == _solo_tokens(params, gone_p, 6)
    assert d["store_fetches"] == 1 and d["store_fetch_misses"] == 1
    assert d["store_fetch_blocks"] == 0 and d["handoff_imports"] == 0
    assert wt == _solo_tokens(params, wt_p, 6) and errored and writes == 0


def test_tier_evictions_sink_to_store_and_journal_header(params, worlds,
                                                        tmp_path):
    """A tiny host tier turns pool evictions into store writes (a sunk
    digest reads back); the journal header carries the store section, and
    a replay on a store-less engine is exact with the section surfaced;
    an evicted chain leaves every tier."""

    def scenario(ns):
        root = str(tmp_path / ns.name)
        eng = ns.engine(params[ns.name], **dict(
            KINDS["dense"], num_slots=2, prefix_blocks=4,
            prefix_host_mb=0.0005, kvstore_dir=root, kvstore_mb=8.0))
        journal = ns.journal.WorkloadJournal(capacity=64)
        journal.set_header(ns.journal.engine_header(
            eng, kvstore={"dir": root, "budget_mb": 8.0,
                          "writethrough": True, "secret": 1}))
        sched = ns.sched.Scheduler(eng, journal=journal)
        for s in range(5):
            sched.submit(_prompt(53 + s, 13), _sp(ns, 3, seed=s))
            sched.run_until_idle()
        key = eng.kvstore.manifest()[0]
        blocks, missing = eng.kvstore.get_chain([key])
        dump = journal.dump(None)
        # The replay runs on the shared dense world's engine B, which
        # has no store and none of these prompts cached.
        fresh = ns.sched.Scheduler(worlds(ns.name, "dense")[1].engine)
        verdict = ns.journal.replay_journal(dump, scheduler=fresh)
        last = _prompt(57, 13)
        evict = (fresh.engine.cached_prefix_blocks(last),
                 fresh.engine.evict_prefix_chain(_digests(last)),
                 fresh.engine.cached_prefix_blocks(last),
                 set(_digests(last)) <= set(fresh.engine.dropped_digests()),
                 fresh.engine.evict_prefix_chain(_digests(last)),
                 fresh.engine.evict_prefix_chain(["zz-not-hex", ""]))
        return (eng.kvstore.writes, sorted(eng.kvstore.manifest()),
                len(blocks), missing, eng.kvstore_namespace,
                dump["header"]["engine"]["kvstore_dir"] == root,
                dump["header"]["engine"]["kvstore_mb"], verdict["exact"],
                dict(verdict["kvstore_config"],
                     dir=verdict["kvstore_config"]["dir"] == root), evict)

    writes, _, n, missing, ns_, dir_ok, mb, exact, cfg, evict = _both(
        scenario)
    assert writes > 0 and n == 1 and missing == []
    assert ns_ == j_kvstore.kvstore_namespace(None, JAX_CFG)
    assert dir_ok and mb == 8.0 and exact is True
    assert cfg == {"dir": True, "budget_mb": 8.0, "writethrough": True}
    assert evict[0] > 0 and evict[1] == 3 and evict[2] == 0
    assert evict[3] and evict[4] == 0 and evict[5] == 0


# ---------------------------------------------------------------------------
# The router's store hint and ring feeds (:664-718)
# ---------------------------------------------------------------------------
class _RowsClient:
    def __init__(self, rows):
        self.rows = rows

    def stats(self):
        return [dict(r) for r in self.rows]

    def health(self):
        return [{"verdict": r.get("health", "healthy")} for r in self.rows]


def _row(health="healthy"):
    return {"queue_depth": 0, "active_slots": 0, "num_slots": 2,
            "decode_tokens_per_sec": 100.0, "health": health,
            "role": "mixed", "slo_breaches": 0}


def _mk_router(ns, rows):
    return ns.router.Router(client=_RowsClient(rows), registry=ns.Registry(),
                            events=ns.EventLog(), refresh_s=0.0,
                            prefix_block=BLOCK)


def _router_store(ns):
    prompt = list(range(16))
    digests = ns.router.prompt_block_digests(prompt, BLOCK)
    r = _mk_router(ns, [_row(), _row()])
    r.directory.observe_store(digests)
    rec = [r.plan(prompt).kv_hint]
    r.observe_route(prompt, 1)
    rec.append(r.plan(prompt, alive=[0]).kv_hint)
    r2 = _mk_router(ns, [_row(), _row(health="unreachable")])
    r2.observe_route(prompt, 1)
    r2.directory.observe_store(digests)
    plan = r2.plan(prompt, alive=[0])
    rec.append((plan.replica, plan.kv_hint))
    rows = [_row()]
    r3 = _mk_router(ns, rows)
    rows[0]["kvstore"] = {"recent_writes": [d.hex() for d in digests],
                          "recent_dropped": []}
    r3.refresh()
    rec.append(r3.directory.store_chain(digests))
    rows[0]["kvstore"] = {"recent_writes": [],
                          "recent_dropped": [digests[0].hex(), "not-hex"]}
    r3.refresh()
    r3.refresh()
    rec += [r3.directory.store_chain(digests),
            r3.directory.store_holds(digests[1])]
    return rec


def test_router_store_hint_and_ring_feeds_match_jax():
    rec = _both(_router_store)
    digs = [d.hex() for d in t_router.prompt_block_digests(list(range(16)),
                                                           BLOCK)]
    assert rec[0] == {"peer": None, "store": True, "digests": digs,
                      "blocks": 4}
    assert rec[1]["peer"] == 1 and "store" not in rec[1]
    assert rec[2][0] == 0 and rec[2][1]["store"] is True
    assert rec[3:] == [4, 0, True]


# ---------------------------------------------------------------------------
# The namespace fence (:923-1040)
# ---------------------------------------------------------------------------
def _isolation(ns, root):
    legacy = ns.kvstore.FleetKVStore(root)
    ns_a = ns.kvstore.FleetKVStore(root, namespace="aaaa1111aaaa1111")
    ns_b = ns.kvstore.FleetKVStore(root, namespace="bbbb2222bbbb2222")
    rec = [legacy.put_blocks(_fake_blocks(2)),
           ns_a.put_blocks([(_hexd(5), _blk(5), _blk(105))])]
    blocks, missing = ns_a.get_chain([_hexd(0)])
    rec += [blocks, missing, ns_a.misses, ns_a.corrupt,
            os.path.exists(legacy.backend._path(_hexd(0)))]
    shutil.copy(legacy.backend._path(_hexd(0)),
                ns_a.backend._path(ns_a._key(_hexd(0))))
    blocks, missing = ns_a.get_chain([_hexd(0)])
    rec += [blocks, missing, ns_a.corrupt,
            os.path.exists(ns_a.backend._path(ns_a._key(_hexd(0)))),
            ns_b.get_chain([_hexd(5)])]
    got, _ = ns_a.get_chain([_hexd(5)])
    rec += [len(got), _np(got[0][1]).tolist(), sorted(legacy.manifest()),
            ns_a.manifest(), ns_b.manifest()]
    return rec


def test_namespace_is_the_jax_packages_and_fences_stores(params, tmp_path):
    """The namespace is the reference's pure function of (checkpoint,
    config), dataclass or dict; one directory holds legacy and two
    namespaced stores that never serve each other; a port engine given
    only ``kvstore_dir`` derives the reference's namespace and an
    explicit one wins."""
    for ckpt, cfg in (("/ckpts/a", CFG), ("/ckpts/a", dataclasses.asdict(CFG)),
                      ("/ckpts/b", CFG), (None, CFG),
                      ("/ckpts/a", dataclasses.replace(CFG, n_layer=4))):
        j_cfg = cfg if isinstance(cfg, dict) else jgpt.GPTConfig(
            **dataclasses.asdict(cfg))
        assert t_kvstore.kvstore_namespace(ckpt, cfg) == \
            j_kvstore.kvstore_namespace(ckpt, j_cfg)
    ns = t_kvstore.kvstore_namespace("/ckpts/a", CFG)
    assert ns != t_kvstore.kvstore_namespace("/ckpts/b", CFG)
    assert len(ns) == 16 and int(ns, 16) >= 0
    rec = _both(lambda n: _isolation(n, str(tmp_path / n.name)))
    assert rec[2:7] == [[], [_hexd(0)], 1, 0, True]
    assert rec[7:11] == [[], [_hexd(0)], 1, False]
    assert rec[11] == ([], [_hexd(5)]) and rec[12] == 1
    assert rec[14:] == [sorted([_hexd(0), _hexd(1)]), [_hexd(5)], []]
    eng = t_engine.DecodeEngine(params["torch"], CFG, device="cpu",
                                kvstore_dir=str(tmp_path / "kv"),
                                **KINDS["dense"])
    assert eng.kvstore_namespace == j_kvstore.kvstore_namespace(None, JAX_CFG)
    assert eng.kvstore.namespace == eng.kvstore_namespace
    eng2 = t_engine.DecodeEngine(params["torch"], CFG, device="cpu",
                                 kvstore_dir=str(tmp_path / "kv"),
                                 kvstore_namespace="cafe0123cafe0123",
                                 **KINDS["dense"])
    assert eng2.kvstore.namespace == "cafe0123cafe0123"


# ---------------------------------------------------------------------------
# End to end on the fabric (tests/test_kvstore.py:844), slow as there
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_e2e_fleet_bounce_warm_starts_and_parks(params, tmp_path,
                                                monkeypatch):
    """A real two-replica fleet of the port writes through and parks a
    session; a fresh fleet on the same directory seeds its directory
    from the manifest and serves the revisit through a store fetch:
    tokens equal, no graph captured after construction."""
    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.serve.client import start_replicas
    from ray_lightning_tpu_torch.utils.state_stream import (
        state_stream_to_file,
        to_state_stream,
    )

    monkeypatch.setenv("RLT_NUM_GPUS", "0")
    ckpt = str(tmp_path / "kvstore.ckpt")
    state_stream_to_file(to_state_stream({
        "params": params["torch"], "gpt_config": dataclasses.asdict(CFG)}),
        ckpt)
    kw = dict(ckpt_path=ckpt, device="cpu", kvfleet=True, rpc_timeout_s=60.0,
              kvstore_dir=str(tmp_path / "store"), kvstore_mb=64.0,
              kvstore_writethrough=True, **KINDS["dense"])
    prompt = _prompt(67, 14)
    expected = _solo_tokens(params, prompt, 8)
    fabric.init(num_cpus=4)
    try:
        client = start_replicas(2, **kw)
        client.router = t_router.Router(client=client, refresh_s=0.0,
                                        prefix_block=BLOCK, shed=False)
        try:
            h = client.submit(prompt, max_new_tokens=8, seed=0)
            assert list(client.stream_handle(h, timeout_s=120)) == expected
            park = client.park_session(h, wait_s=30.0)
            assert park["stored"] == park["blocks"] > 0
            assert sum((s.get("kvstore") or {}).get("writes", 0)
                       for s in client.stats()) > 0
        finally:
            client.shutdown()
        client = start_replicas(2, **kw)
        client.router = t_router.Router(client=client, refresh_s=0.0,
                                        prefix_block=BLOCK, shed=False)
        try:
            assert client.seed_store_directory(client.router) > 0
            assert list(client.stream(prompt, max_new_tokens=8, seed=0,
                                      timeout_s=120)) == expected
            stats = client.stats()
            assert sum((s.get("kvfleet") or {}).get("store_fetches", 0)
                       for s in stats) >= 1
            assert sum((s.get("kvstore") or {}).get("hits", 0)
                       for s in stats) > 0
            assert sum((s.get("prefix") or {}).get("hit_tokens", 0)
                       for s in stats) > 0
            assert all(s["compiles_since_init"] == 0 for s in stats)
        finally:
            client.shutdown()
    finally:
        fabric.shutdown()


def _faces(ns, root):
    """tests/test_kvstore.py:719 and tests/test_kvfleet.py:928 without the
    CLI's frame (item 14): the store's and the plane's registry series
    and the fleet row ``summarize_replica`` keeps of them."""
    import ray_lightning_tpu.obs.fleet as j_fleet
    import ray_lightning_tpu_torch.obs.fleet as t_fleet

    reg = ns.Registry()
    store = ns.kvstore.FleetKVStore(root, registry=reg)
    store.put_blocks(_fake_blocks(2))
    store.get_chain([_hexd(0), _hexd(9)])
    inboxes = {0: queue.Queue(), 1: queue.Queue()}
    plane = ns.kvfleet.KVFleetPlane(
        index=0, role="prefill", inbox=inboxes[0], peers=dict(inboxes),
        block_bytes=128, min_poll_s=0.0, registry=reg)
    plane.request_fetch("r1", 1, [_hexd(1)])
    plane.ship(1, "r2", [(_hexd(2), _blk(2), _blk(3))])
    lines = sorted(line for line in reg.render().splitlines()
                   if ("kvstore" in line or "kvfleet" in line)
                   and not line.startswith("#"))
    fleet = j_fleet if ns.name == "jax" else t_fleet
    row = fleet.summarize_replica({"queue_depth": 0, "role": "prefill",
                                   "kvfleet": plane.stats(),
                                   "kvstore": store.stats()})
    row["kvstore"].pop("path", None)
    return lines, row, fleet.summarize_replica({"queue_depth": 0})


def test_store_and_plane_series_and_rows_match_jax(tmp_path):
    lines, row, bare = _both(lambda ns: _faces(ns, str(tmp_path / ns.name)))
    for frag in ("rlt_serve_kvstore_writes_total 2",
                 "rlt_serve_kvstore_hits_total 1",
                 "rlt_serve_kvstore_misses_total 1",
                 'rlt_serve_kvfleet_fetches_total{role="prefill"} 1',
                 'rlt_serve_kvfleet_ships_total{role="prefill"} 1'):
        assert frag in lines, frag
    assert row["kvstore"]["writes"] == 2 and row["kvfleet"]["ships"] == 1
    assert row["kvstore"]["recent_writes"] == [_hexd(0), _hexd(1)]
    assert bare["kvstore"] is None
