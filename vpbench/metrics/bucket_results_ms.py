"""The mean ``repro_torch.serve.results`` span of the traced stretch: a
bucket from its last fetch to its results (each request's clones of states
and pending, the overflow checks, the ``SnnResult``s)."""
from vpbench import hostspans


def read(rec):
    return hostspans.mean_ms(rec, hostspans.RESULTS)
