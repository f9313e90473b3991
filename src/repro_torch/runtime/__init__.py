"""Runtime of the training loop: fault tolerance and int8 gradient
compression (the reference's elastic remesh goes with the mesh, which the
port does not have yet)."""
