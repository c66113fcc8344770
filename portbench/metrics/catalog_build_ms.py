"""``propagation.build_catalog(text, device="cuda")`` of the cell's TLE
text: parse, SGP4 and SDP4 init, the catalog on the card; the
benchmark's own span around the call, synchronized. Host clock."""


def read(run):
    return run.catalog_build_ms
