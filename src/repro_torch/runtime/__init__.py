"""Runtime of the training loop: fault tolerance, int8 gradient
compression and the elastic re-mesh plan."""
