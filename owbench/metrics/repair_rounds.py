"""Mean repair rounds a step over the window (`StepResult.rounds`, the
program's count)."""


def read(run):
    if not run.rounds:
        return None
    return sum(run.rounds) / len(run.rounds)
