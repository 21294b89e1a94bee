"""The sharding-spec tokens and rule-table checks the runtime validator
uses (``specs.py``).  The static hvdshard pass is ROADMAP queue A item
12."""
