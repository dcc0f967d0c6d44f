"""One module a kind of traffic: ``run(ctx)`` drives the program through a cell."""
