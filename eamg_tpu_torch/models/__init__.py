"""The GPT decoder and the DistilBERT emotion classifier."""
