"""The transformer LM's elastic training entry (`train`)."""
