"""``tracker.host_ms``: the tracker's own host time per frame: its spans
(``update``, or each resumption of ``update_deferred``) less the third
round's and the ReID extractor's spans inside them."""


def read(run):
    frames = sum(s[4] for s in run.spans_of("tracker"))
    if not frames:
        return None
    own = run.self_seconds("tracker", {"assoc", "reid", "detector"})
    return own / frames * 1e3
