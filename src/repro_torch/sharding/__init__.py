"""Sharding over a ``torch.distributed`` ``DeviceMesh`` (port of
``repro/sharding``): the logical-axis rules (``rules``), the batch padding
of ``compat``, the collectives over a mesh dim (``collectives``), the
audit that reads their record (``audit``) and the GPipe pipeline
(``pipeline``)."""
