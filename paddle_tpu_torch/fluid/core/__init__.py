"""The static core's runtime pieces: dtypes, places, the scope, the op
registry and the op-sequence interpreter."""
