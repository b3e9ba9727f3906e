"""``assoc.call_ms``: host-clock time per third-round call
(``AssociationEngine.associate`` / ``associate_many``), which ends in a host
read of its probabilities."""


def read(run):
    spans = run.spans_of("assoc")
    return (sum(s[2] - s[1] for s in spans) / len(spans) * 1e3
            if spans else None)
