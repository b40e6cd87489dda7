"""The CTR flagship's elastic training entry (`train`)."""
