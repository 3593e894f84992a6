"""Launch layer: device meshes (``mesh``), the sharding rules
(``sharding``), the EF-int8 gradient exchange (``compression``), the train
step and its sharded form (``train``), the training driver (``train_efm``)
and the serving shim (``serve``).  The reference's dry-run and HLO parser
(``launch/dryrun.py``, ``launch/hloparse.py``) are not ported yet
(``ROADMAP.md`` Queue 1 item 6)."""
