"""The `map_insert` stage of the urban replay's window rows: from its stamp to
the next stamp inside the captured step (`utils.profiling.Tracer`), the
mean over the rows, in ms of device time; on a row that folds, the
insert up to the fold's stamp (`fold_ms.urban` has the fold)."""


def read(run):
    return run.get("urban", {}).get("stage_ms", {}).get("map_insert")
