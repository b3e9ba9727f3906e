"""``serve.overhead_ms``: the serving layer's cost per frame, the mean over
replies of the client's round trip minus the server's own time in the reply
(``tick_ms`` of the lockstep server, ``ms`` of the single server): the
socket, the queue and the JSON."""


def read(run):
    o = run.served_overheads
    return sum(o) / len(o) if o else None
