"""The one traffic generator: a mix file (``benchmark/mixes/<name>.json``)
and a seed give every stream's frames and public detections.

A stream is a crowd of coloured boxes over a textured background, drawn by
the frozen renderer (:mod:`bmk.synthetic`), at a MOTChallenge resolution.
The seed changes where the objects are, their colours and motion, and where
their detector dropouts and score dips fall; it never changes how many
streams, objects, frames or windows there are, so every seed gives the same
amount of work.

A stream holds ``frames`` rendered frames and is played forward and back
(0, 1, ..., n-1, n-2, ..., 1, 0, 1, ...), which keeps the motion continuous
and bounds memory and set-up.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from bmk.synthetic import SyntheticObject, SyntheticSequence

# object sizes and speeds at 1080 rows, as the smoke crowd draws them
BOX_W, BOX_H = (40.0, 80.0), (100.0, 200.0)
SPEED_X, SPEED_Y = 2.0, 1.0


@dataclasses.dataclass
class CrowdObject(SyntheticObject):
    """A renderer object with any number of dropout and score-dip windows."""

    dropouts: Tuple[Tuple[int, int], ...] = ()
    dips: Tuple[Tuple[int, int], ...] = ()

    def detected_at(self, t: int) -> bool:
        return not any(lo <= t < hi for lo, hi in self.dropouts)

    def score_at(self, t: int, base: float) -> float:
        if any(lo <= t < hi for lo, hi in self.dips):
            return self.dip_score
        return base


def seed_rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one purpose of one run: any whole seed, negative or
    above 2**32, with ``keys`` naming the purpose."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *keys]))


def windows(rng, n_frames: int, share: float, length: Tuple[int, int]):
    """Periodic windows of one object, so that ``share`` of the objects sit
    in one at any frame: a length drawn from ``length`` (inclusive), a
    period of length / share, a random phase."""
    if share <= 0:
        return ()
    n = int(rng.integers(length[0], length[1] + 1))
    period = max(n + 1, int(round(n / share)))
    start = int(rng.integers(0, period)) - period
    out = []
    while start < n_frames:
        lo, hi = max(start, 0), min(start + n, n_frames)
        if hi > lo:
            out.append((lo, hi))
        start += period
    return tuple(out)


def crowd(rng, n_objects: int, height: int, width: int, n_frames: int,
          mix: dict) -> List[CrowdObject]:
    """``n_objects`` distinct colours whose whole trajectories stay in the
    frame, sized for ``height`` rows, with the mix's dropouts and dips."""
    s = height / 1080.0
    drop = mix.get("dropout", {})
    dip = mix.get("score_dip", {})
    objs = []
    while len(objs) < n_objects:
        color = rng.integers(30, 226, 3).astype(np.float64)
        if any(np.abs(color - o.color).sum() < 40 for o in objs):
            continue
        bw = rng.uniform(*BOX_W) * s
        bh = rng.uniform(*BOX_H) * s
        vx = rng.uniform(-SPEED_X, SPEED_X) * s
        vy = rng.uniform(-SPEED_Y, SPEED_Y) * s
        span = n_frames - 1
        x0 = rng.uniform(max(0.0, -vx * span),
                         width - bw - max(0.0, vx * span))
        y0 = rng.uniform(max(0.0, -vy * span),
                         height - bh - max(0.0, vy * span))
        drops = windows(rng, n_frames, drop.get("share", 0.0),
                        tuple(drop.get("length", (4, 12))))
        dips = windows(rng, n_frames, dip.get("share", 0.0),
                       tuple(dip.get("length", (4, 12))))
        objs.append(CrowdObject(color=color, x0=x0, y0=y0, vx=vx, vy=vy,
                                w=bw, h=bh, dropouts=drops, dips=dips,
                                dip_score=float(dip.get("score", 0.3))))
    return objs


@dataclasses.dataclass
class Stream:
    name: str
    sequence: SyntheticSequence

    @property
    def shape(self):
        return (self.sequence.height, self.sequence.width, 3)


def streams(mix: dict, seed: int) -> List[Stream]:
    """The mix's streams for ``seed`` (``mix["streams"]``: name, height,
    width and objects each; ``mix["frames"]`` rendered frames a stream).
    A mix with a ``traffic_seed`` draws its crowds from it, the same for
    every run; ``seed`` then only picks where each stream starts or the
    order the streams connect in (``seed_orders``: :func:`phases`,
    :func:`stream_order`)."""
    out = []
    n = int(mix["frames"])
    seed = int(mix.get("traffic_seed", seed))
    for i, st in enumerate(mix["streams"]):
        rng = seed_rng(seed, 1, i)
        objs = crowd(rng, int(st["objects"]), int(st["height"]),
                     int(st["width"]), n, mix)
        render_seed = int(rng.integers(0, 2**31 - 2))
        seq = SyntheticSequence(objs, num_frames=n, height=int(st["height"]),
                                width=int(st["width"]), det_noise=1.0,
                                det_score=0.9, seed=render_seed)
        out.append(Stream(st["name"], seq))
    return out


def render(stream: Stream) -> List[np.ndarray]:
    """Every rendered frame of a stream, in order."""
    return [stream.sequence.frame(t) for t in range(stream.sequence.num_frames)]


def public_detections(stream: Stream):
    """The renderer's detections of every frame (the public detections of
    the in-process cells), drawn once in frame order."""
    return [stream.sequence.detections(t)
            for t in range(stream.sequence.num_frames)]


def phases(mix: dict, seed: int) -> List[int]:
    """Each stream's first step on its forward-and-back loop: drawn from
    ``seed`` where the mix's ``seed_orders`` is ``phases`` (every seed plays
    the same frames from other starting points), else 0."""
    period = max(2 * (int(mix["frames"]) - 1), 1)
    if mix.get("seed_orders") != "phases":
        return [0] * len(mix["streams"])
    return [int(seed_rng(seed, 5, i).integers(0, period))
            for i in range(len(mix["streams"]))]


def stream_order(mix: dict, seed: int) -> List[int]:
    """The order in which the streams connect to a server: a permutation
    drawn from ``seed`` where the mix's ``seed_orders`` is ``streams``
    (every seed sends the same frames, batched in another order), else the
    mix's order."""
    n = len(mix["streams"])
    if mix.get("seed_orders") != "streams":
        return list(range(n))
    return [int(i) for i in seed_rng(seed, 6).permutation(n)]


def pingpong(k: int, n: int) -> int:
    """The rendered frame shown at step ``k`` of a stream of ``n`` frames
    played forward and back."""
    if n == 1:
        return 0
    p = 2 * (n - 1)
    k %= p
    return k if k < n else p - k


def rehearsal(mix: dict) -> dict:
    """The mix at its CPU-rehearsal size (``mix["rehearse"]``: a scale of
    the frames, a count of objects, and keys that replace the mix's, such
    as its frames and samples)."""
    r = mix["rehearse"]
    out = dict(mix, **{k: v for k, v in r.items()
                       if k not in ("scale", "objects")})
    out["streams"] = [dict(st, height=int(round(st["height"] * r["scale"])),
                           width=int(round(st["width"] * r["scale"])),
                           objects=int(r["objects"]))
                      for st in mix["streams"]]
    return out
