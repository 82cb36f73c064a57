"""One module per kind of run (``traffic/<mix>.json``'s ``kind``): each
module's ``run(ctx)`` sets up the port from the seed, measures the window,
optionally traces a few more iterations, checks the timed path against the
reference and returns the run's record."""
