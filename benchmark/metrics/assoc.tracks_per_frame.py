"""``assoc.tracks_per_frame``: tracks scored by third-round calls, counted
from the calls' arguments, per frame: the witness that a cell exercises
BUSCA's third round or bypasses it (0 is a reading)."""


def read(run):
    frames = sum(s[4] for s in run.spans_of("tracker"))
    if not frames:
        return None
    tracks = sum(f[2] for f in run.forwards if f[0] == "tracks")
    return tracks / frames
