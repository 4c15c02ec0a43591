"""Launch-side modules: the production and host device meshes with the
card's rates (`mesh`), the roofline over dry-run records (`roofline`) and
the per-cell dry-run on a fake process group (`dryrun`)."""
