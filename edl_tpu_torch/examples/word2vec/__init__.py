"""word2vec's fault-tolerant elastic entry (`train_ft`)."""
