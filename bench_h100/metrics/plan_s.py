"""Host clock around rt.attach_wjd(A) in set-up: the planner's time."""


def read(run):
    return run.plan_s
