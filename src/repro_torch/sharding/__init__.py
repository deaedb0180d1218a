"""Sharding over a ``torch.distributed`` ``DeviceMesh`` (port of
``repro/sharding``): the logical-axis rules (``rules``), the batch padding
of ``compat``, the collectives over a mesh dim (``collectives``), the
autograd collectives of tensor-parallel compute over ``"model"``
(``tensor_parallel``), the audit that reads their record (``audit``) and
the GPipe pipeline (``pipeline``)."""
