"""Port parity: the tuner (utils/tune.py) and the tuned dslash
(ops/wilson_pallas.tuned_dslash) against the JAX package's.

The tuned dslash races the JAX package's candidate set; on the CPU both
packages race ``xla`` and ``xla_packed`` and their outputs agree within
1e-6 (complex64).  The cache: a round trip through tunecache.json under
``QUDA_TORCH_RESOURCE_PATH``, the platform prefix of the key (a winner
raced on one kind of hardware is not served on another), entries without
a platform dropped, tuning off returning the first candidate untimed, and
a raising candidate failing the race (the port's one difference from the
JAX tuner, which skips it).  Numpy seeds 371-379.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quda_tpu.ops import wilson_pallas as jwpl
from quda_tpu_torch.fields.geometry import LatticeGeometry
from quda_tpu_torch.ops import boundary as bnd
from quda_tpu_torch.ops import wilson_pallas as wpl
from quda_tpu_torch.utils import tune

from tests.torch_inputs import (SMALL, gaussian, lattice_shape,
                                rel_err, su3_gauge)
from tests.torch_inputs import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def fresh_tuner(monkeypatch, tmp_path):
    """An empty in-process cache and profile, a resource path under
    tmp_path, tuning on; the tuner's state is restored afterwards."""
    saved = (dict(tune._cache), dict(tune._profile), tune._loaded_path)
    tune._cache.clear()
    tune._profile.clear()
    monkeypatch.setattr(tune, "_loaded_path", None)
    monkeypatch.setenv("QUDA_TORCH_RESOURCE_PATH", str(tmp_path))
    monkeypatch.delenv("QUDA_TORCH_ENABLE_TUNING", raising=False)
    yield tmp_path
    tune._cache.clear()
    tune._cache.update(saved[0])
    tune._profile.clear()
    tune._profile.update(saved[1])
    tune._loaded_path = saved[2]


def _counting(value):
    """A candidate that counts its calls and returns ``value``."""
    def fn(x):
        fn.calls += 1
        return x + value
    fn.calls = 0
    return fn


def test_tuned_dslash_matches_jax(fresh_tuner):
    """The port's tuned dslash on CPU tensors races JAX's candidate names
    on the CPU (``xla``, ``xla_packed``) and its output equals JAX's
    tuned_dslash within 1e-6 (complex64, folded SU(3) links)."""
    geom = LatticeGeometry(SMALL)
    g = bnd.apply_t_boundary(torch.from_numpy(su3_gauge(SMALL, 371)), geom,
                             -1)
    psi = torch.from_numpy(gaussian(lattice_shape(SMALL) + (4, 3), 372))
    got = wpl.tuned_dslash(g, psi)
    lat = tuple(lattice_shape(SMALL))
    cands = wpl._tuned_candidates(lat, str(psi.dtype), "cpu")
    assert list(cands) == list(jwpl._tuned_candidates(
        lat, str(jnp.complex64), "cpu"))
    assert list(cands) == ["xla", "xla_packed"]
    want = np.asarray(jwpl.tuned_dslash(jnp.asarray(g.numpy()),
                                        jnp.asarray(psi.numpy())))
    assert got.dtype == torch.complex64 and got.shape == psi.shape
    assert rel_err(got.numpy(), want) < 1e-6
    # every candidate computes the same hop
    for fn in cands.values():
        assert rel_err(fn(g, psi).numpy(), want) < 1e-6
    key = tune.tune_key("wilson_dslash", lat, f"{psi.dtype}/cpu")
    assert tune.cached_param("wilson_dslash", lat,
                             f"{psi.dtype}/cpu") in cands
    assert key.startswith("cpu:cpu:n1|")


def test_cache_round_trip(fresh_tuner):
    """A race writes its winner, with the platform, to tunecache.json; a
    new session's warm_start loads it and the next tune serves it with
    no candidate called; save_profile writes the raced timings."""
    x = torch.ones(4)
    a, b = _counting(1.0), _counting(2.0)
    win = tune.tune("probe", (4,), {"a": a, "b": b}, (x,), aux="t",
                    reps=2, inner=2)
    assert win in ("a", "b") and a.calls == b.calls == 1 + 2 * 2
    raw = json.loads((fresh_tuner / tune.CACHE_FILE).read_text())
    key = tune.tune_key("probe", (4,), "t")
    assert raw[key]["param"] == win
    assert raw[key]["platform"] == tune.platform_key()
    tune._cache.clear()
    assert tune.warm_start() == 1
    assert tune.tune("probe", (4,), {"a": a, "b": b}, (x,), aux="t") == win
    assert a.calls == b.calls == 5
    prof = (fresh_tuner / "profile_0.tsv")
    assert tune.save_profile() == str(prof)
    lines = prof.read_text().splitlines()
    assert lines[0].startswith("key\tcalls") and len(lines) == 3


def test_platform_keys_differ(fresh_tuner, monkeypatch):
    """The key names the hardware: ``cpu:cpu:n1`` without a card,
    ``cuda:<name>:n<count>`` with one; a winner raced on one platform is
    not served on the other, which races anew."""
    x = torch.ones(2)
    a, b = _counting(1.0), _counting(2.0)
    cpu_key = tune.platform_key()
    tune.tune("probe", (2,), {"a": a, "b": b}, (x,), reps=1, inner=1)
    assert a.calls == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card_key = tune.platform_key()
    assert card_key == "cuda:NVIDIA-H100-80GB-HBM3:n1" != cpu_key
    assert tune.cached_param("probe", (2,)) is None
    tune.tune("probe", (2,), {"a": a, "b": b}, (x,), reps=1, inner=1)
    assert a.calls == 4
    assert {k.split("|")[0] for k in tune._cache} == {cpu_key, card_key}


def test_stale_entries_dropped(fresh_tuner):
    """Entries without a platform field (the pre-platform schema) are not
    loaded; a well-formed entry is."""
    good = tune.tune_key("probe", (3,), "")
    (fresh_tuner / tune.CACHE_FILE).write_text(json.dumps({
        "old|(3,)|probe|": {"param": "a", "time": 1.0},
        good: {"param": "b", "time": 1.0, "platform": tune.platform_key()}}))
    stats = tune.load_cache()
    assert (stats["entries"], stats["stale"]) == (1, 1)
    assert tune.cache_snapshot() == {good: {"param": "b", "time": 1.0,
                                            "platform": tune.platform_key()}}


def test_raising_candidate_propagates(fresh_tuner):
    """A candidate that raises fails the race (the JAX tuner skips it);
    nothing is cached."""
    def broken(x):
        raise RuntimeError("kernel failed to launch")

    with pytest.raises(RuntimeError, match="failed to launch"):
        tune.tune("probe", (5,), {"ok": _counting(0.0), "broken": broken},
                  (torch.ones(1),))
    assert tune.cached_param("probe", (5,)) is None
    assert not (fresh_tuner / tune.CACHE_FILE).exists()


def test_tuning_off_returns_first_candidate(fresh_tuner, monkeypatch):
    """QUDA_TORCH_ENABLE_TUNING=0: the first candidate, untimed and
    uncached, as the JAX tuner does."""
    monkeypatch.setenv("QUDA_TORCH_ENABLE_TUNING", "0")
    a, b = _counting(1.0), _counting(2.0)
    assert tune.tune("probe", (6,), {"b": b, "a": a},
                     (torch.ones(1),)) == "b"
    assert a.calls == b.calls == 0 and tune._cache == {}
    monkeypatch.setenv("QUDA_TORCH_ENABLE_TUNING", "maybe")
    with pytest.raises(ValueError, match="boolean"):
        tune.tune("probe", (6,), {"a": a}, (torch.ones(1),))


def test_init_quda_warm_starts(fresh_tuner):
    """init_quda loads the cache under the resource path."""
    import quda_tpu_torch as qt
    key = tune.tune_key("probe", (7,), "")
    (fresh_tuner / tune.CACHE_FILE).write_text(json.dumps({
        key: {"param": "a", "time": 1.0, "platform": tune.platform_key()}}))
    qt.init_quda(device="cpu")
    try:
        assert tune.cached_param("probe", (7,)) == "a"
    finally:
        qt.end_quda()
