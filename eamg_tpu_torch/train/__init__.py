"""Training-side helpers of the port. So far only the synthetic corpora
and the row padding (``train/data.py``) that the Medusa probe reads;
training itself is not in the port yet."""
