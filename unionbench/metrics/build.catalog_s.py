"""Seconds in the program's relation and join construction and its engine
build (tree joins, membership indexes, upload)."""


def read(run):
    return run.spans.seconds.get("build.catalog_s")
