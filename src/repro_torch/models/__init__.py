"""Decoder models of the tier pools: a port of the dense-attention path of
``repro/models`` (configs, parameter specs, layers, GQA attention on the
two attention kernels, gated MLP, blocks and the prefill/decode model)."""
