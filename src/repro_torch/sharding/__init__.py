"""Stream sharding of the serving path over a ``torch.distributed``
``DeviceMesh`` (port of ``repro/sharding``'s serving half): the batch
padding of ``compat``, the in-round collectives over the mesh's ``"data"``
group (``collectives``) and the audit that reads their record
(``audit``)."""
