"""The harness's shared code: the spec, a run's record, the trace."""
