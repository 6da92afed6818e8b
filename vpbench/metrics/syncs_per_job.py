"""The fleet server's host fetches over the requests it finished in the
window (``SnnServer.dispatch_syncs`` and ``served``, their growth)."""


def read(rec):
    if not rec.served:
        return None
    return rec.syncs / rec.served
