"""The rank side of the multi-host simulation: the counterpart of the worker
half of ``tpudra.sim.multihost``.  Its launcher, which reserves the gang
through the driver's control plane, is ``tools/torch_multihost.py``."""
