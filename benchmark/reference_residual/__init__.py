"""The plain reference of configurations whose graphs are not chains
(``model.py``): a residual graph's parse and tensor walk, and TFLite's
integer ``ADD``, over the frozen parser helpers, fold, IR classes and ops
of ``benchmark/reference/``, which it imports and changes in nothing.
Imports nothing of the program under test."""
