"""Runtime analysis of the eager core: the collective fingerprint
(``fingerprint.py``).  The reference's static passes are ROADMAP queue A
item 12."""
