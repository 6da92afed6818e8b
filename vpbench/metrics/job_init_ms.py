"""The mean ``repro_torch.controller.init`` span of the traced stretch: a
new ``Controller``'s copies to the device, its segment step and tables."""
from vpbench import hostspans


def read(rec):
    return hostspans.mean_ms(rec, hostspans.INIT)
