"""The benchmark's counters of work: operations and bytes worked out from
shapes, one file a kernel family."""
