"""Experimental namespace (reference `genjax.experimental`): staging
ground for APIs whose shape may still change. Empty, as in the
reference."""

__all__: list[str] = []
