"""The batched template search (:mod:`.search`)."""
