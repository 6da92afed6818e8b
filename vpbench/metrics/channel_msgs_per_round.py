"""The channel's messages in the traced stretch (``stats["msgs"]`` of its
finished requests: every message a segment's outbox sent into the channel)
over the stretch's rounds; None where the entry does not count them."""


def read(rec):
    msgs = getattr(rec, "trace_msgs", None)
    if msgs is None or not rec.trace_rounds:
        return None
    return msgs / rec.trace_rounds
