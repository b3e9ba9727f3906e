"""``serve.queue_wait_ms``: the mean time a frame waits in the lockstep
server's queue, from its arrival on its connection's thread to the tick
that takes it (the program's ``serve.queue_wait`` span), over the frames
of the profiled window."""

from bmk.program_spans import program_trace


def read(run):
    pt = program_trace(run)
    waits = pt.named("serve.queue_wait") if pt is not None else []
    return pt.host_ms("serve.queue_wait") / len(waits) if waits else None
