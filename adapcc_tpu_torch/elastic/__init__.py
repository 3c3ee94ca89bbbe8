"""Elastic world picture (the port of :mod:`adapcc_tpu.elastic`, so far its
:mod:`~adapcc_tpu_torch.elastic.worldview`; fault plans, rebalancing and
standby plans come with the elasticity slice)."""
