"""The flagship transformer and dense-cache decoding."""
