"""The traced stretch's ``repro_torch.dispatch.issue`` spans (the host's
issue of a dispatch: buffer copies, fills, the graph's replay) over its
buckets."""
from vpbench import hostspans


def read(rec):
    return hostspans.per_bucket_ms(rec, hostspans.DISPATCH)
