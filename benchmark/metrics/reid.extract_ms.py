"""``reid.extract_ms``: host-clock time per frame in the feature trackers'
ReID extractor (``FeatureShim`` -> ``ReidFeatureExtractor``, the detections'
and the Kalman candidates' features), each call ending in a host read of
the features."""


def read(run):
    frames = sum(s[4] for s in run.spans_of("tracker"))
    spans = run.spans_of("reid")
    if not frames or not spans:
        return None
    return run.span_seconds("reid") / frames * 1e3
