"""Launch layer: device meshes (``mesh``), the sharding rules
(``sharding``), the EF-int8 gradient exchange (``compression``), the train
step and its sharded form (``train``), the training driver (``train_efm``),
the serving shim (``serve``), and the dry-run of every (arch x shape x
mesh) cell on a fake process group (``dryrun``) with its collective
accounting (``hloparse``)."""
