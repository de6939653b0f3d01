"""The benchmark's frozen plain reference: physics, step glue, learner
update and the roofline count. Plain numpy and torch; nothing of the
program is imported here."""
