"""The port's native record cache (``vit4hep_tpu_torch/data/native_cache.py``
over ``vit4hep_tpu_torch/native/record_cache.cpp``) against the JAX
package's (``vit4hep_tpu/data/native_cache.py``), on the CPU:

- both packages' ``build_cache`` write byte-identical files from the same
  field dicts, and each package's ``NativeRecordCache`` reads the other's
  file to the same arrays, bit for bit;
- the guards of JAX's ``tests/test_lemurs.py``: the spec forms, an empty
  gather, a closed cache, a truncated file, a wrong magic or version, an
  index out of range;
- the port builds its library from its own source into
  ``vit4hep_tpu_torch/_build/`` and names it after the source's digest;
- a LEMURS dataset (HDF5 files, several detectors), a CaloHadronic dataset
  (HDF5) and events held in memory (``ArrayEvents``) give the same batches,
  classes included, with the cache as without it, bit for bit, and a
  cache built by the JAX package from the same files is the port's file,
  byte for byte (the same name, from the same fingerprint).

The LEMURS launcher with ``data.native_cache`` set is in
``tests/test_torch_lemurs.py`` (its training equals the run without it).
"""

import struct

import h5py
import numpy as np
import pytest

from vit4hep_tpu.data import native_cache as jnc
from vit4hep_tpu.data.lemurs import datasets as jds
from vit4hep_tpu_torch.data import native_cache as tnc
from vit4hep_tpu_torch.data.calohadronic.datasets import CaloHadDataset
from vit4hep_tpu_torch.data.lemurs import datasets as tds

H, W, L = 9, 16, 45
LEMURS_SPEC = {"incident_energy": (1,), "incident_theta": (1,), "incident_phi": (1,),
               "showers": (H, W, L)}


def _fields(rng, n):
    return {"b_field": rng.normal(size=(n, 3)).astype(np.float32),
            "a_field": rng.normal(size=(n, 2, 2)).astype(np.float32)}


SPEC = {"b_field": (3,), "a_field": (2, 2)}


def test_both_packages_write_the_same_bytes_and_read_each_other(tmp_path):
    rng = np.random.default_rng(0)
    batches = [_fields(rng, 7), _fields(rng, 5)]
    port, jax_file = tmp_path / "port.v4cache", tmp_path / "jax.v4cache"
    tnc.build_cache(port, iter(batches), SPEC)
    jnc.build_cache(jax_file, iter(batches), SPEC)
    assert port.read_bytes() == jax_file.read_bytes()
    magic, version, n, size = struct.unpack("<QQQQ", port.read_bytes()[:32])
    assert (magic, version, n, size) == (0x56344845503, 2, 12, 4 * 7)

    idx = np.array([11, 0, 3, 3, 7])
    want = {k: np.concatenate([b[k] for b in batches])[idx] for k in SPEC}
    for reader in (tnc.NativeRecordCache, jnc.NativeRecordCache):
        for path in (port, jax_file):
            cache = reader(path, SPEC)
            assert len(cache) == 12
            got = cache.gather(idx)
            for k in SPEC:
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k])
            cache.close()


def test_library_builds_from_the_port_source(tmp_path):
    tnc._load_lib()
    path = tnc.lib_path()
    assert path.exists() and path.parent == tnc.BUILD_DIR
    assert tnc.BUILD_DIR.name == "_build" and tnc.BUILD_DIR.parent.name == "vit4hep_tpu_torch"
    assert tnc.SOURCE.parent.name == "native" and tnc.SOURCE.parent.parent.name == \
        "vit4hep_tpu_torch"
    assert tnc.lib_path().name.startswith("librecord_cache-")


def test_compiler_missing_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        tnc._compiler()


def test_spec_forms():
    plain = {"incident_energy": (), "showers": (H, W, L)}
    pairs = {"incident_energy": ((), np.float32), "showers": ((H, W, L), np.float32)}
    assert tnc.normalize_spec(plain) == tnc.normalize_spec(pairs) == jnc.normalize_spec(pairs)
    assert list(tnc.normalize_spec({"z": (1,), "a": (2,)})) == ["a", "z"]
    assert tnc.record_size_of(plain) == 4 * (1 + H * W * L)
    with pytest.raises(ValueError, match="float32"):
        tnc.normalize_spec({"showers": ((H, W, L), np.float64)})
    with pytest.raises(ValueError, match="shape tuple"):
        tnc.normalize_spec({"showers": "huge"})
    with pytest.raises(ValueError, match="elements per record"):
        tnc.build_cache("/dev/null", iter([{"b_field": np.zeros((2, 4)), "a_field":
                                             np.zeros((2, 4))}]), SPEC)


def test_guards(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "guards.v4cache"
    tnc.build_cache(path, iter([_fields(rng, 10)]), SPEC)
    cache = tnc.NativeRecordCache(path, SPEC)
    out = cache.gather(np.array([], np.int64))
    assert out["a_field"].shape == (0, 2, 2) and out["b_field"].shape == (0, 3)
    for bad in ([10], [-1], [0, 99]):
        with pytest.raises(IndexError, match="out of range"):
            cache.gather(bad)
    with pytest.raises(ValueError, match="record size"):
        tnc.NativeRecordCache(path, {"a_field": (5,)})
    cache.close()
    with pytest.raises(ValueError, match="closed"):
        cache.gather([0])

    data = path.read_bytes()
    for name, blob in (("truncated", data[:-8]),
                       ("magic", struct.pack("<Q", 0x1234) + data[8:]),
                       ("version", data[:8] + struct.pack("<Q", 1) + data[16:])):
        bad = tmp_path / f"{name}.v4cache"
        bad.write_bytes(blob)
        with pytest.raises(OSError, match="cannot open"):
            tnc.NativeRecordCache(bad, SPEC)
    with pytest.raises(OSError, match="cannot open"):
        tnc.NativeRecordCache(tmp_path / "missing.v4cache", SPEC)


def _lemurs_events(n, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype([(k, np.float32) for k in LEMURS_SPEC if k != "showers"]
                  + [("showers", np.float32, (H, W, L))])
    events = np.zeros(n, dt)
    for k in LEMURS_SPEC:
        events[k] = rng.random(events[k].shape)
    return events


def _write(path, events):
    with h5py.File(path, "w") as f:
        f.create_dataset("events", data=events)
    return str(path)


def _assert_same_batches(plain, cached, idx):
    want, want_cls = plain.read_indices(idx)
    got, got_cls = cached.read_indices(idx)
    np.testing.assert_array_equal(got_cls, want_cls)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_lemurs_dataset_batches_equal_with_the_cache(tmp_path):
    files = {"ODD": [_write(tmp_path / "odd_0.h5", _lemurs_events(6, 0)),
                     _write(tmp_path / "odd_1.h5", _lemurs_events(5, 1))],
             "Par04SiW": [_write(tmp_path / "siw.h5", _lemurs_events(7, 2))]}
    plain, cached = tds.LEMURSDataset(files), tds.LEMURSDataset(files)
    tds.enable_native_cache(cached, tmp_path / "cache", LEMURS_SPEC)
    idx = np.random.default_rng(3).permutation(len(plain))
    _assert_same_batches(plain, cached, idx)

    # the JAX package builds the same file under the same name
    jax_ds = jds.LEMURSDataset(files)
    jds.enable_native_cache(jax_ds, tmp_path / "jax_cache", LEMURS_SPEC)
    (port_file,) = (tmp_path / "cache").iterdir()
    (jax_file,) = (tmp_path / "jax_cache").iterdir()
    assert port_file.name == jax_file.name and port_file.name.startswith("LEMURSDataset_18_")
    assert port_file.read_bytes() == jax_file.read_bytes()

    # a second dataset reuses the file; the iterator runs over the cache
    again = tds.LEMURSDataset(files)
    tds.enable_native_cache(again, tmp_path / "cache", LEMURS_SPEC)
    assert len(list((tmp_path / "cache").iterdir())) == 1
    _assert_same_batches(plain, again, [17, 0, 5])
    batches = list(tds.CollatedBatchIterator(again, lambda d, c: (d["showers"], c), 4,
                                             shuffle=False).epoch_batches())
    assert len(batches) == 4
    np.testing.assert_array_equal(batches[1][0], plain.read_indices(range(4, 8))[0]["showers"])


def test_calohad_and_array_events_batches_equal_with_the_cache(tmp_path):
    ecal, hcal = (3, 6, 6), (4, 3, 3)
    rng = np.random.default_rng(4)
    dt = np.dtype([("energy", np.float32), ("ecal", np.float32, ecal),
                   ("hcal", np.float32, hcal)])
    events = np.zeros(9, dt)
    for k in ("energy", "ecal", "hcal"):
        events[k] = rng.random(events[k].shape)
    files = {"CaloHad": [_write(tmp_path / "train.h5", events)]}
    spec = {"energy": (1,), "ecal": ecal, "hcal": hcal}
    plain, cached = CaloHadDataset(files), CaloHadDataset(files)
    tds.enable_native_cache(cached, tmp_path / "cache", spec)
    _assert_same_batches(plain, cached, [8, 1, 4, 0])

    by_label = {"a": {"energy": rng.random((5, 1), np.float32),
                      "ecal": rng.random((5, *ecal), np.float32),
                      "hcal": rng.random((5, *hcal), np.float32)},
                "b": {"energy": rng.random((3, 1), np.float32),
                      "ecal": rng.random((3, *ecal), np.float32),
                      "hcal": rng.random((3, *hcal), np.float32)}}
    mem, mem_cached = tds.ArrayEvents(by_label), tds.ArrayEvents(by_label)
    assert mem.spec() == spec
    tds.enable_native_cache(mem_cached, tmp_path / "cache", spec)
    _assert_same_batches(mem, mem_cached, [7, 0, 5, 2])
    # other events in memory of the same counts get a cache of their own
    other = tds.ArrayEvents({k: {f: v + 1 for f, v in ev.items()} for k, ev in by_label.items()})
    tds.enable_native_cache(other, tmp_path / "cache", spec)
    np.testing.assert_array_equal(other.read_indices([6])[0]["ecal"], by_label["b"]["ecal"][1:2]
                                  + 1)
    names = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert len(names) == 3 and sum(n.startswith("ArrayEvents_8_") for n in names) == 2
