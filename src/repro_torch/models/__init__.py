"""Decoder models of the tier pools: a port of ``repro/models`` (configs,
parameter specs, layers, GQA attention on the two attention kernels, gated
MLP and MoE, SSM and RG-LRU mixers, blocks, the prefill/decode model and
the training loss)."""
