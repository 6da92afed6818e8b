"""The traced stretch's ``repro_torch.dispatch.fetch`` spans (the host
blocked until the dispatch's carries are on the host) over its buckets."""
from vpbench import hostspans


def read(rec):
    return hostspans.per_bucket_ms(rec, hostspans.FETCH)
