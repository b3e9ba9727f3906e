"""Tracker-state snapshot and restore: elastic recovery for long streams
(port of ``busca_tpu.serve.snapshot``).

All tracking state lives in host numpy and Python objects: the device holds
the detector's and the association engine's weights plus a crop cache whose
contents never change results.  A snapshot is therefore a pickle of the
tracker with its device handles detached; restore re-attaches live handles
and the stream continues exactly where it left off.  Crop mirrors lose their
bank unit ids on unpickle and are uploaded again on first use, which costs
time only (the bank is a cache).

What is captured: the whole wrapper chain (``FeatureShim`` or
``CenterTrackShim`` -> ``CenterTrackAdapter`` -> tracker), every track store,
each track's Kalman state and appearance memory (crop mirrors as uint8), the
CMC reference frame, per-tracker id cursors, the process-wide track-id
counters (``Track._count``, ``SortTrack._count``, ``MotdtTrack._count``) so
that restored and new ids never collide, and a ``meta`` dict the caller
round-trips (the server keeps the stream position and the stateful
detector's previous canvas there).

What is not captured: the association engine and the feature extractor
(device programs, re-attached on restore from an argument or from a
``donor`` built by the same factory) and one-shot ECC warp hints.

Take a snapshot between ``update()`` calls (the server does: one frame is
one request).

Security, two independent layers:

1. Restore unpickles with an exact ``(module, name)`` allowlist of this
   package's state classes plus numpy's array reconstruction.  Any other
   global (a function, another class, anything of ``torch`` or of
   ``busca_tpu``) is refused before anything is built.  A torch tensor
   pickles through torch's rebuild functions, which are call gadgets, so
   tracker state must hold none: :func:`snapshot_bytes` refuses an object of
   ``torch`` when it pickles, rather than write a blob that restore would
   refuse.  A blob of ``busca_tpu`` (the JAX package) names its own classes
   and is refused by name.
2. Optionally, blobs are HMAC-SHA256 signed (``key=`` on both sides): with a
   key, restore refuses a blob whose tag does not verify before it unpickles
   anything.  Without a key, layer 1 still holds, but an unsigned blob is
   state the operator trusts, like any checkpoint.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import io
import pickle
import threading
from typing import Optional, Tuple

FORMAT_VERSION = 2

# the signed envelope: MAGIC + HMAC-SHA256(key, payload) (32 bytes) + payload
_SIGNED_MAGIC = b"BSNPSIG1"
_TAG_LEN = 32

# attributes that hold live device handles or one-shot callables: detached
# before pickling, re-attached (or recomputed) on restore
_DETACH_ATTRS = ("engine", "feature_extractor", "feat_fn", "_warp_hint")
# attributes through which one tracker object wraps another
# (FeatureShim.trk, CenterTrackShim.trk, CenterTrackAdapter.tracker)
_WRAPPER_ATTRS = ("tracker", "trk")

# guards the read-advance of the process-wide id counters against each other
# (each IdCounter is thread-safe on its own)
_COUNTER_LOCK = threading.Lock()


def _chain(tracker):
    """The wrapper chain, outermost first (cycle-safe)."""
    out, obj = [], tracker
    while obj is not None and not any(obj is o for o in out):
        out.append(obj)
        obj = next((getattr(obj, a) for a in _WRAPPER_ATTRS
                    if getattr(obj, a, None) is not None), None)
    return out


def _counter_classes():
    from busca_tpu_torch.trackers.base import Track
    from busca_tpu_torch.trackers.motdt import MotdtTrack
    from busca_tpu_torch.trackers.sort import SortTrack

    return {"base.Track": Track, "sort.SortTrack": SortTrack,
            "motdt.MotdtTrack": MotdtTrack}


def sign_blob(payload: bytes, key: bytes) -> bytes:
    return (_SIGNED_MAGIC + _hmac.new(key, payload, hashlib.sha256).digest()
            + payload)


def verify_blob(blob: bytes, key: Optional[bytes]) -> bytes:
    """Strip (and with a key, verify) the signature envelope; returns the
    raw payload.

    With a key the blob must be signed and its tag must verify.  Without
    one, a signed blob's payload is taken unverified (the restricted
    unpickler still holds): set the same key on both sides for
    authenticity.
    """
    signed = blob.startswith(_SIGNED_MAGIC)
    head = len(_SIGNED_MAGIC) + _TAG_LEN
    if key is not None:
        if not signed:
            raise ValueError(
                "snapshot restore requires an HMAC-signed blob (a key is "
                "configured) but the blob is unsigned")
        tag, payload = blob[len(_SIGNED_MAGIC):head], blob[head:]
        want = _hmac.new(key, payload, hashlib.sha256).digest()
        if not _hmac.compare_digest(tag, want):
            raise ValueError("snapshot HMAC verification failed")
        return payload
    return blob[head:] if signed else blob


class _StatePickler(pickle.Pickler):
    """Refuses torch objects: a tensor, device, dtype or generator left in
    tracker state would pickle through torch's rebuild functions, which the
    restore allowlist refuses."""

    def reducer_override(self, obj):
        module = type(obj).__module__
        if module == "torch" or module.startswith("torch."):
            raise pickle.PicklingError(
                f"snapshot state holds a {module}.{type(obj).__qualname__}: "
                "tracker state must be host numpy or plain Python")
        return NotImplemented


def snapshot_bytes(tracker, meta: Optional[dict] = None,
                   key: Optional[bytes] = None) -> bytes:
    """Serialize a tracker (or a wrapper chain) to a snapshot blob.

    Call between ``update()`` calls.  The live tracker gets its detached
    handles back before this returns.

    Args:
      meta: an optional picklable dict, returned by
        :func:`restore_with_meta` as it was (stream position, detector
        state); its contents must pass the restore allowlist (plain
        containers, numpy arrays, allowlisted classes).
      key: an optional HMAC key; the blob is then signed.
    """
    stash = []
    try:
        for obj in _chain(tracker):
            for name in _DETACH_ATTRS:
                if name in getattr(obj, "__dict__", {}):
                    stash.append((obj, name, obj.__dict__[name]))
                    obj.__dict__[name] = None
        with _COUNTER_LOCK:
            counters = {k: c._count.peek()
                        for k, c in _counter_classes().items()}
        payload = {"version": FORMAT_VERSION, "counters": counters,
                   "meta": dict(meta) if meta else {}, "tracker": tracker}
        buf = io.BytesIO()
        _StatePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
        raw = buf.getvalue()
        return sign_blob(raw, key) if key is not None else raw
    finally:
        for obj, name, val in stash:
            obj.__dict__[name] = val


# The exact (module, name) allowlist: every class a snapshot of this
# package's trackers holds, and numpy's array reconstruction.
# tests/test_torch_snapshot.py::test_allowlist_covers_every_tracker_flavor
# keeps it honest: a newly pickled class fails that test.  Nothing here runs
# code: numpy's primitives build arrays from bytes, and each class is plain
# state whose construction has no side effects.
_ALLOWED = {
    "builtins": {"set", "frozenset", "slice", "range", "bytearray",
                 "complex"},
    "collections": {"OrderedDict", "deque"},
    "numpy": {"ndarray", "dtype"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.numeric": {"_frombuffer"},
    # numpy < 2 module paths (the same objects)
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy.core.numeric": {"_frombuffer"},
    "busca_tpu_torch.assoc.bank": {"BankedCrop"},
    "busca_tpu_torch.core.hostmath": {"HostKalman"},
    "busca_tpu_torch.eval.run": {"CenterTrackShim", "FeatureShim"},
    "busca_tpu_torch.trackers.base": {"Track"},
    "busca_tpu_torch.trackers.byte": {"ByteTracker", "ByteTrackerConfig"},
    "busca_tpu_torch.trackers.centertrack": {"CenterTrackAdapter"},
    "busca_tpu_torch.trackers.ghost": {"GhostConfig", "GhostTrack",
                                       "GhostTracker"},
    "busca_tpu_torch.trackers.motdt": {"MotdtConfig", "MotdtTrack",
                                       "MotdtTracker"},
    "busca_tpu_torch.trackers.sort": {"SortConfig", "SortTrack",
                                      "SortTracker"},
    "busca_tpu_torch.trackers.strongsort": {
        "NearestNeighborMetric", "SSTrack", "StrongSortConfig",
        "StrongSortTracker"},
    "busca_tpu_torch.trackers.transcenter": {"TransCenterByteTracker"},
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in _ALLOWED.get(module, ()):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"snapshot blob references forbidden {module}.{name}")


def restore_with_meta(blob: bytes, engine=None, feature_extractor=None,
                      donor=None, key: Optional[bytes] = None
                      ) -> Tuple[object, dict]:
    """Rebuild a tracker from a snapshot blob and re-attach live handles.

    Args:
      blob: bytes from :func:`snapshot_bytes` (signed or raw).
      engine: the association engine, put back wherever the chain held one.
      feature_extractor: the ReID feature callable, put back as
        ``GhostTracker.feature_extractor`` and ``FeatureShim.feat_fn``.
      donor: instead, a fresh tracker from the same factory that built the
        snapshotted one; its live handles are taken from the matching
        places of its wrapper chain (the server's restore path).
      key: an optional HMAC key; the blob must then be signed and verify.

    Returns:
      ``(tracker, meta)``: the restored tracker and the snapshot's ``meta``
      (``{}`` if none).

    Raises:
      ValueError: on a bad signature or format, on a donor whose chain does
        not match, or if the snapshot was taken with BUSCA attached
        (``use_busca``) and no engine was given: restoring without one would
        silently change tracking.
      pickle.UnpicklingError: on a global outside the allowlist.
    """
    raw = verify_blob(blob, key)
    payload = _RestrictedUnpickler(io.BytesIO(raw)).load()
    if not isinstance(payload, dict) or "tracker" not in payload:
        raise ValueError("not a tracker snapshot blob")
    version = payload.get("version")
    if version != FORMAT_VERSION:
        raise ValueError(f"snapshot format {version!r} is not the "
                         f"supported {FORMAT_VERSION}")
    tracker = payload["tracker"]
    chain = _chain(tracker)

    if donor is not None:
        donor_chain = _chain(donor)
        names = [type(o).__name__ for o in chain]
        donor_names = [type(o).__name__ for o in donor_chain]
        if donor_names != names:
            raise ValueError(f"donor chain {donor_names} does not match "
                             f"snapshot chain {names}")
        for obj, src in zip(chain, donor_chain):
            for name in ("engine", "feature_extractor", "feat_fn"):
                if name in getattr(obj, "__dict__", {}):
                    live = getattr(src, name, None)
                    if live is not None:
                        obj.__dict__[name] = live
    else:
        for obj in chain:
            d = getattr(obj, "__dict__", {})
            if engine is not None and "engine" in d:
                d["engine"] = engine
            if feature_extractor is not None:
                for name in ("feature_extractor", "feat_fn"):
                    if name in d:
                        d[name] = feature_extractor

    for obj in chain:
        if getattr(obj, "use_busca", False) and \
                getattr(obj, "engine", None) is None:
            raise ValueError(
                f"snapshot of {type(obj).__name__} was taken with BUSCA "
                "attached (use_busca=True); pass engine= or donor= to "
                "restore_bytes: restoring without one would silently change "
                "tracking")

    # never regress the process-wide id counters: ids minted after the
    # restore must not collide with the restored tracks'
    with _COUNTER_LOCK:
        for name, cls in _counter_classes().items():
            saved = payload.get("counters", {}).get(name)
            if saved is not None:
                cls._count.advance_to(int(saved))
    return tracker, payload.get("meta") or {}


def restore_bytes(blob: bytes, engine=None, feature_extractor=None,
                  donor=None, key: Optional[bytes] = None):
    """:func:`restore_with_meta` without the meta."""
    return restore_with_meta(blob, engine=engine,
                             feature_extractor=feature_extractor,
                             donor=donor, key=key)[0]


def save(tracker, path: str, meta: Optional[dict] = None,
         key: Optional[bytes] = None):
    with open(path, "wb") as f:
        f.write(snapshot_bytes(tracker, meta=meta, key=key))


def load(path: str, engine=None, feature_extractor=None, donor=None,
         key: Optional[bytes] = None):
    with open(path, "rb") as f:
        return restore_bytes(f.read(), engine=engine,
                             feature_extractor=feature_extractor,
                             donor=donor, key=key)
