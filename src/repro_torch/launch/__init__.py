"""Launch layer: the train step.  The mesh, sharding, dry-run and serve
shims of ``repro/launch`` need a device mesh (``ROADMAP.md`` Queue 1
item 6)."""
