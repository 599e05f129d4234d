"""Routes over more than one image or device: the batch route (`mesh`)."""
