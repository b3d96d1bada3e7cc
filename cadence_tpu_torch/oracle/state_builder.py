"""Oracle state builder: replays history event batches into mutable state.

This is the Python semantic twin of the reference's replay hot loop:

- the per-event switch:  service/history/execution/state_builder.go:90-647
- Replicate* semantics:  service/history/execution/mutable_state_builder.go
- decision transitions:  service/history/execution/mutable_state_decision_task_manager.go

`apply_batch` corresponds to one `ApplyEvents` call (one persisted event
batch / transaction); `replay_history` corresponds to
`stateRebuilder.Rebuild`'s paginated loop
(service/history/execution/state_rebuilder.go:102-148).
"""
from __future__ import annotations

from typing import List, Optional

from ..core.enums import (
    EMPTY_EVENT_ID,
    EMPTY_UUID,
    EMPTY_VERSION,
    TIMER_TASK_STATUS_NONE,
    CloseStatus,
    EventType,
    TimeoutType,
    WorkflowState,
)
from ..core.events import HistoryBatch, HistoryEvent, RetryPolicy
from . import task_generator as taskgen
from .mutable_state import (
    ActivityInfo,
    ChildExecutionInfo,
    DecisionInfo,
    DomainEntry,
    MutableState,
    ReplayError,
    RequestCancelInfo,
    SignalInfo,
    TimerInfo,
    seconds_to_nanos,
)


class StateBuilder:
    """Replays event batches into a MutableState (passive/rebuild path)."""

    def __init__(self, mutable_state: Optional[MutableState] = None,
                 domain_entry: Optional[DomainEntry] = None,
                 clear_sticky: bool = True) -> None:
        self.ms = mutable_state if mutable_state is not None else MutableState(domain_entry)
        #: mutable state of the continued-as-new run, when one was applied
        self.new_run_state: Optional[MutableState] = None
        #: the REPLAY path clears stickyness — the workflow turned passive
        #: (state_builder.go:108); the ACTIVE engine routes its own
        #: transactions through this same builder (active ≡ replayed by
        #: construction) and passes False so sticky execution survives
        #: between decisions
        self.clear_sticky = clear_sticky

    # ------------------------------------------------------------------
    # Entry points
    # ------------------------------------------------------------------

    def replay_history(self, batches: List[HistoryBatch]) -> MutableState:
        """Replay a full history, batch by batch (state_rebuilder.go:114-148)."""
        for batch in batches:
            self.apply_batch(batch)
        return self.ms

    def apply_batch(self, batch: HistoryBatch) -> MutableState:
        """One ApplyEvents call; reference state_builder.go:90-647."""
        if not batch.events:
            raise ReplayError("encounter history size being zero")
        ms = self.ms
        first_event = batch.events[0]
        last_event = batch.events[-1]

        # need to clear the stickiness since workflow turned to passive (:108)
        if self.clear_sticky:
            ms.clear_stickyness()

        for event in batch.events:
            ms.update_current_version(event.version, force_update=True)  # :112
            ms.version_histories.current().add_or_update_item(event.id, event.version)  # :123
            ms.execution_info.last_event_task_id = event.task_id  # :129
            self._apply_event(batch, first_event, event)

        # activity/user timers are generated at the very end (:634-640)
        taskgen.generate_activity_timer_tasks(ms)
        taskgen.generate_user_timer_tasks(ms)

        ms.execution_info.last_first_event_id = first_event.id  # :642
        ms.execution_info.next_event_id = last_event.id + 1  # :643
        return ms

    # ------------------------------------------------------------------
    # The event-type switch (state_builder.go:131-631)
    # ------------------------------------------------------------------

    def _apply_event(self, batch: HistoryBatch, first_event: HistoryEvent,
                     event: HistoryEvent) -> None:
        ms = self.ms
        et = event.event_type

        if et == EventType.WorkflowExecutionStarted:
            self._replicate_workflow_execution_started(batch, event)
            taskgen.generate_record_workflow_started_tasks(ms, event)
            taskgen.generate_workflow_start_tasks(ms, event.timestamp, event)
            if (event.get("first_decision_task_backoff_seconds", 0) or 0) > 0:
                taskgen.generate_delayed_decision_tasks(ms, event)

        elif et == EventType.DecisionTaskScheduled:
            decision = self._replicate_decision_task_scheduled(
                version=event.version,
                schedule_id=event.id,
                task_list=event.get("task_list", ""),
                start_to_close_timeout=event.get("start_to_close_timeout_seconds", 0) or 0,
                attempt=event.get("attempt", 0) or 0,
                scheduled_timestamp=event.timestamp,
                original_scheduled_timestamp=event.timestamp,
            )
            taskgen.generate_decision_schedule_tasks(ms, decision.schedule_id)

        elif et == EventType.DecisionTaskStarted:
            decision = self._replicate_decision_task_started(
                version=event.version,
                schedule_id=event.get("scheduled_event_id"),
                started_id=event.id,
                request_id=event.get("request_id", ""),
                timestamp=event.timestamp,
            )
            taskgen.generate_decision_start_tasks(ms, decision.schedule_id)

        elif et == EventType.DecisionTaskCompleted:
            self._replicate_decision_task_completed(event)

        elif et == EventType.DecisionTaskTimedOut:
            self._replicate_decision_task_timed_out(
                TimeoutType(event.get("timeout_type", TimeoutType.StartToClose))
            )
            decision = self._replicate_transient_decision_task_scheduled(event)
            if decision is not None:
                taskgen.generate_decision_schedule_tasks(ms, decision.schedule_id)

        elif et == EventType.DecisionTaskFailed:
            self._fail_decision(increment_attempt=True, now=event.timestamp)
            decision = self._replicate_transient_decision_task_scheduled(event)
            if decision is not None:
                taskgen.generate_decision_schedule_tasks(ms, decision.schedule_id)

        elif et == EventType.ActivityTaskScheduled:
            self._replicate_activity_task_scheduled(first_event.id, event)
            taskgen.generate_activity_transfer_tasks(ms, event)

        elif et == EventType.ActivityTaskStarted:
            self._replicate_activity_task_started(event)

        elif et in (
            EventType.ActivityTaskCompleted,
            EventType.ActivityTaskFailed,
            EventType.ActivityTaskTimedOut,
            EventType.ActivityTaskCanceled,
        ):
            # mutable_state_builder.go:2312,:2354,:2400,:2528 — all reduce to
            # DeleteActivity(scheduledEventID)
            ms.delete_activity(event.get("scheduled_event_id"))

        elif et == EventType.ActivityTaskCancelRequested:
            self._replicate_activity_task_cancel_requested(event)

        elif et == EventType.RequestCancelActivityTaskFailed:
            pass  # no mutable state action (state_builder.go:339-340)

        elif et == EventType.TimerStarted:
            self._replicate_timer_started(event)

        elif et == EventType.TimerFired:
            ms.delete_user_timer(event.get("timer_id"))  # :3109-3117

        elif et == EventType.TimerCanceled:
            ms.delete_user_timer(event.get("timer_id"))  # :3160-3168

        elif et == EventType.CancelTimerFailed:
            pass  # no mutable state action (state_builder.go:363-364)

        elif et == EventType.StartChildWorkflowExecutionInitiated:
            self._replicate_start_child_initiated(first_event.id, event)
            taskgen.generate_child_workflow_tasks(ms, event)

        elif et == EventType.StartChildWorkflowExecutionFailed:
            ms.delete_pending_child_execution(event.get("initiated_event_id"))

        elif et == EventType.ChildWorkflowExecutionStarted:
            self._replicate_child_started(event)

        elif et in (
            EventType.ChildWorkflowExecutionCompleted,
            EventType.ChildWorkflowExecutionFailed,
            EventType.ChildWorkflowExecutionCanceled,
            EventType.ChildWorkflowExecutionTimedOut,
            EventType.ChildWorkflowExecutionTerminated,
        ):
            # mutable_state_builder.go:3590-3810 — DeletePendingChildExecution
            ms.delete_pending_child_execution(event.get("initiated_event_id"))

        elif et == EventType.RequestCancelExternalWorkflowExecutionInitiated:
            self._replicate_request_cancel_initiated(first_event.id, event)
            taskgen.generate_request_cancel_external_tasks(ms, event)

        elif et in (
            EventType.RequestCancelExternalWorkflowExecutionFailed,
            EventType.ExternalWorkflowExecutionCancelRequested,
        ):
            ms.delete_pending_request_cancel(event.get("initiated_event_id"))

        elif et == EventType.SignalExternalWorkflowExecutionInitiated:
            self._replicate_signal_external_initiated(first_event.id, event)
            taskgen.generate_signal_external_tasks(ms, event)

        elif et in (
            EventType.SignalExternalWorkflowExecutionFailed,
            EventType.ExternalWorkflowExecutionSignaled,
        ):
            ms.delete_pending_signal(event.get("initiated_event_id"))

        elif et == EventType.MarkerRecorded:
            pass  # no mutable state action (state_builder.go:494-495)

        elif et == EventType.WorkflowExecutionSignaled:
            ms.execution_info.signal_count += 1  # :3260-3267
            # repopulate the at-least-once dedup set from the event's
            # request id (mutable_state_builder.go AddSignalRequested on
            # the replicate path): a redelivered cross-cluster signal
            # after recovery/promotion must stay a no-op
            request_id = event.get("request_id", "")
            if request_id:
                ms.signal_requested_ids.add(request_id)

        elif et == EventType.WorkflowExecutionCancelRequested:
            ms.execution_info.cancel_requested = True  # :2688-2694

        elif et == EventType.UpsertWorkflowSearchAttributes:
            self._replicate_upsert_search_attributes(event)
            taskgen.generate_workflow_search_attr_tasks(ms)

        elif et == EventType.WorkflowExecutionCompleted:
            self._complete_workflow(first_event.id, event, CloseStatus.Completed)

        elif et == EventType.WorkflowExecutionFailed:
            self._complete_workflow(first_event.id, event, CloseStatus.Failed)

        elif et == EventType.WorkflowExecutionTimedOut:
            self._complete_workflow(first_event.id, event, CloseStatus.TimedOut)

        elif et == EventType.WorkflowExecutionCanceled:
            self._complete_workflow(first_event.id, event, CloseStatus.Canceled)

        elif et == EventType.WorkflowExecutionTerminated:
            self._complete_workflow(first_event.id, event, CloseStatus.Terminated)

        elif et == EventType.WorkflowExecutionContinuedAsNew:
            self._replicate_continued_as_new(batch, first_event.id, event)

        else:
            raise ReplayError(f"Unknown event type: {et}")

    # ------------------------------------------------------------------
    # Replicate* implementations
    # ------------------------------------------------------------------

    def _replicate_workflow_execution_started(self, batch: HistoryBatch,
                                              event: HistoryEvent) -> None:
        """Reference: mutable_state_builder.go:1751-1829."""
        ms = self.ms
        info = ms.execution_info
        info.create_request_id = batch.request_id
        info.domain_id = batch.domain_id
        info.workflow_id = batch.workflow_id
        info.run_id = batch.run_id
        info.first_execution_run_id = event.get("first_execution_run_id", batch.run_id)
        info.task_list = event.get("task_list", "")
        info.workflow_type_name = event.get("workflow_type", "")
        info.workflow_timeout = event.get("execution_start_to_close_timeout_seconds", 0) or 0
        info.decision_start_to_close_timeout = event.get("task_start_to_close_timeout_seconds", 0) or 0
        info.start_timestamp = event.timestamp

        info.update_workflow_state_close_status(WorkflowState.Created, CloseStatus.Nothing)
        info.last_processed_event = EMPTY_EVENT_ID
        info.last_first_event_id = event.id

        info.decision_version = EMPTY_VERSION
        info.decision_schedule_id = EMPTY_EVENT_ID
        info.decision_started_id = EMPTY_EVENT_ID
        info.decision_request_id = EMPTY_UUID
        info.decision_timeout = 0

        info.cron_schedule = event.get("cron_schedule", "") or ""
        info.first_decision_backoff = event.get(
            "first_decision_task_backoff_seconds", 0) or 0

        parent_domain_id = event.get("parent_workflow_domain_id")
        if parent_domain_id:
            info.parent_domain_id = parent_domain_id
        if event.get("parent_workflow_id"):
            info.parent_workflow_id = event.get("parent_workflow_id")
            info.parent_run_id = event.get("parent_run_id", "")
        if event.get("parent_initiated_event_id") is not None:
            info.initiated_id = event.get("parent_initiated_event_id")
        else:
            info.initiated_id = EMPTY_EVENT_ID

        info.attempt = event.get("attempt", 0) or 0
        expiration_ts = event.get("expiration_timestamp", 0) or 0
        if expiration_ts != 0:
            info.expiration_time = expiration_ts
        retry: Optional[RetryPolicy] = event.get("retry_policy")
        if retry is not None:
            info.has_retry_policy = True
            info.backoff_coefficient = retry.backoff_coefficient
            info.expiration_seconds = retry.expiration_interval_seconds
            info.initial_interval = retry.initial_interval_seconds
            info.maximum_attempts = retry.maximum_attempts
            info.maximum_interval = retry.maximum_interval_seconds
            info.non_retriable_errors = list(retry.non_retriable_error_reasons)

        memo = event.get("memo")
        if memo:
            info.memo = dict(memo)
        search_attributes = event.get("search_attributes")
        if search_attributes:
            info.search_attributes = dict(search_attributes)

    # -- decision state machine (mutable_state_decision_task_manager.go) ----

    def _update_decision(self, d: DecisionInfo) -> None:
        """Reference: mutable_state_decision_task_manager.go:697-721."""
        info = self.ms.execution_info
        info.decision_version = d.version
        info.decision_schedule_id = d.schedule_id
        info.decision_started_id = d.started_id
        info.decision_request_id = d.request_id
        info.decision_timeout = d.decision_timeout
        info.decision_attempt = d.attempt
        info.decision_started_timestamp = d.started_timestamp
        info.decision_scheduled_timestamp = d.scheduled_timestamp
        info.decision_original_scheduled_timestamp = d.original_scheduled_timestamp
        # NOTE: tasklist deliberately not written to execution info (:710)

    def _replicate_decision_task_scheduled(self, version: int, schedule_id: int,
                                           task_list: str, start_to_close_timeout: int,
                                           attempt: int, scheduled_timestamp: int,
                                           original_scheduled_timestamp: int) -> DecisionInfo:
        """Reference: mutable_state_decision_task_manager.go:129-166."""
        ms = self.ms
        if ms.execution_info.state != WorkflowState.Zombie:
            ms.execution_info.update_workflow_state_close_status(
                WorkflowState.Running, CloseStatus.Nothing
            )
        decision = DecisionInfo(
            version=version,
            schedule_id=schedule_id,
            started_id=EMPTY_EVENT_ID,
            request_id=EMPTY_UUID,
            decision_timeout=start_to_close_timeout,
            task_list=task_list,
            attempt=attempt,
            scheduled_timestamp=scheduled_timestamp,
            started_timestamp=0,
            original_scheduled_timestamp=original_scheduled_timestamp,
        )
        self._update_decision(decision)
        return decision

    def _replicate_transient_decision_task_scheduled(
        self, event: HistoryEvent
    ) -> Optional[DecisionInfo]:
        """Reference: mutable_state_decision_task_manager.go:168-197.

        Uses the event timestamp in place of timeSource.Now() (deterministic;
        not checksum-relevant).
        """
        ms = self.ms
        info = ms.execution_info
        has_pending = info.decision_schedule_id != EMPTY_EVENT_ID
        if has_pending or info.decision_attempt == 0:
            return None
        decision = DecisionInfo(
            version=ms.current_version,
            schedule_id=ms.get_next_event_id(),  # deliberately "wrong", see :173-182
            started_id=EMPTY_EVENT_ID,
            request_id=EMPTY_UUID,
            decision_timeout=info.decision_start_to_close_timeout,
            task_list=info.task_list,
            attempt=info.decision_attempt,
            scheduled_timestamp=event.timestamp,
            started_timestamp=0,
        )
        self._update_decision(decision)
        return decision

    def _replicate_decision_task_started(self, version: int, schedule_id: int,
                                         started_id: int, request_id: str,
                                         timestamp: int) -> DecisionInfo:
        """Reference: mutable_state_decision_task_manager.go:199-242."""
        info = self.ms.execution_info
        if info.decision_schedule_id != schedule_id:
            raise ReplayError(f"unable to find decision: {schedule_id}")
        # transient-decision "magic": attempt reset to 0 on replication (:215-223)
        attempt = 0
        decision = DecisionInfo(
            version=version,
            schedule_id=schedule_id,
            started_id=started_id,
            request_id=request_id,
            decision_timeout=info.decision_timeout,
            attempt=attempt,
            started_timestamp=timestamp,
            scheduled_timestamp=info.decision_scheduled_timestamp,
            task_list=info.sticky_task_list if info.sticky_task_list else info.task_list,
            original_scheduled_timestamp=info.decision_original_scheduled_timestamp,
        )
        self._update_decision(decision)
        return decision

    def _delete_decision(self) -> None:
        """Reference: mutable_state_decision_task_manager.go:679-694."""
        reset = DecisionInfo(
            version=EMPTY_VERSION,
            schedule_id=EMPTY_EVENT_ID,
            started_id=EMPTY_EVENT_ID,
            request_id=EMPTY_UUID,
            decision_timeout=0,
            attempt=0,
            started_timestamp=0,
            scheduled_timestamp=0,
            task_list="",
            # keep last original scheduled timestamp (:690-691)
            original_scheduled_timestamp=self.ms.execution_info.decision_original_scheduled_timestamp,
        )
        self._update_decision(reset)

    def _replicate_decision_task_completed(self, event: HistoryEvent) -> None:
        """Reference: mutable_state_decision_task_manager.go:244-249, 827-838."""
        self._delete_decision()
        self.ms.execution_info.last_processed_event = event.get("started_event_id")
        # addBinaryCheckSumIfNotExists is active-side reset-point bookkeeping;
        # binary checksums are absent from replay corpora (not checksum-relevant)

    def _fail_decision(self, increment_attempt: bool, now: int) -> None:
        """Reference: mutable_state_decision_task_manager.go:643-676."""
        ms = self.ms
        ms.clear_stickyness()
        fail_info = DecisionInfo(
            version=EMPTY_VERSION,
            schedule_id=EMPTY_EVENT_ID,
            started_id=EMPTY_EVENT_ID,
            request_id=EMPTY_UUID,
            decision_timeout=0,
            started_timestamp=0,
            task_list="",
            original_scheduled_timestamp=0,
        )
        if increment_attempt:
            fail_info.attempt = ms.execution_info.decision_attempt + 1
            fail_info.scheduled_timestamp = now
        self._update_decision(fail_info)

    def _replicate_decision_task_timed_out(self, timeout_type: TimeoutType) -> None:
        """Reference: mutable_state_decision_task_manager.go:256-271 — a
        schedule-to-start timeout (the sticky-decision dispatch deadline)
        does NOT increment the attempt, so the follow-up decision is a real
        scheduled event on the normal task list, never a transient."""
        increment = timeout_type != TimeoutType.ScheduleToStart
        self._fail_decision(increment, now=0)

    # -- activities ---------------------------------------------------------

    def _replicate_activity_task_scheduled(self, first_event_id: int,
                                           event: HistoryEvent) -> ActivityInfo:
        """Reference: mutable_state_builder.go:2142-2197."""
        ms = self.ms
        retry: Optional[RetryPolicy] = event.get("retry_policy")
        ai = ActivityInfo(
            version=event.version,
            schedule_id=event.id,
            scheduled_event_batch_id=first_event_id,
            scheduled_time=event.timestamp,
            started_id=EMPTY_EVENT_ID,
            started_time=0,
            activity_id=event.get("activity_id", ""),
            domain_id=event.get("domain_id") or ms.execution_info.domain_id,
            task_list=event.get("task_list", ""),
            schedule_to_start_timeout=event.get("schedule_to_start_timeout_seconds", 0) or 0,
            schedule_to_close_timeout=event.get("schedule_to_close_timeout_seconds", 0) or 0,
            start_to_close_timeout=event.get("start_to_close_timeout_seconds", 0) or 0,
            heartbeat_timeout=event.get("heartbeat_timeout_seconds", 0) or 0,
            cancel_requested=False,
            cancel_request_id=EMPTY_EVENT_ID,
            timer_task_status=TIMER_TASK_STATUS_NONE,
            has_retry_policy=retry is not None,
        )
        if retry is not None:
            ai.initial_interval = retry.initial_interval_seconds
            ai.backoff_coefficient = retry.backoff_coefficient
            ai.maximum_interval = retry.maximum_interval_seconds
            ai.maximum_attempts = retry.maximum_attempts
            ai.non_retriable_errors = list(retry.non_retriable_error_reasons)
            if retry.expiration_interval_seconds != 0:
                ai.expiration_time = ai.scheduled_time + seconds_to_nanos(
                    retry.expiration_interval_seconds
                )
        ms.pending_activity_info_ids[ai.schedule_id] = ai
        ms.pending_activity_id_to_event_id[ai.activity_id] = ai.schedule_id
        return ai

    def _replicate_activity_task_started(self, event: HistoryEvent) -> None:
        """Reference: mutable_state_builder.go:2254-2276."""
        ms = self.ms
        schedule_id = event.get("scheduled_event_id")
        ai = ms.pending_activity_info_ids.get(schedule_id)
        if ai is None:
            raise ReplayError(f"missing activity info for schedule id {schedule_id}")
        ai.version = event.version
        ai.started_id = event.id
        ai.request_id = event.get("request_id", "")
        ai.started_time = event.timestamp
        ai.last_heartbeat_updated_time = ai.started_time

    def _replicate_activity_task_cancel_requested(self, event: HistoryEvent) -> None:
        """Reference: mutable_state_builder.go:2444-2467 — silently ignores
        unknown activity IDs on the passive side (:2451-2454)."""
        ms = self.ms
        activity_id = event.get("activity_id", "")
        schedule_id = ms.pending_activity_id_to_event_id.get(activity_id)
        if schedule_id is None:
            return
        ai = ms.pending_activity_info_ids[schedule_id]
        ai.version = event.version
        ai.cancel_requested = True
        ai.cancel_request_id = event.id

    # -- timers -------------------------------------------------------------

    def _replicate_timer_started(self, event: HistoryEvent) -> TimerInfo:
        """Reference: mutable_state_builder.go:3057-3081."""
        ms = self.ms
        timer_id = event.get("timer_id", "")
        start_to_fire = event.get("start_to_fire_timeout_seconds", 0) or 0
        ti = TimerInfo(
            version=event.version,
            timer_id=timer_id,
            expiry_time=event.timestamp + seconds_to_nanos(start_to_fire),
            started_id=event.id,
            task_status=TIMER_TASK_STATUS_NONE,
        )
        ms.pending_timer_info_ids[timer_id] = ti
        ms.pending_timer_event_id_to_id[ti.started_id] = timer_id
        return ti

    # -- children / external cancels / external signals ---------------------

    def _replicate_start_child_initiated(self, first_event_id: int,
                                         event: HistoryEvent) -> ChildExecutionInfo:
        """Reference: mutable_state_builder.go:3417-3453."""
        ms = self.ms
        ci = ChildExecutionInfo(
            version=event.version,
            initiated_id=event.id,
            initiated_event_batch_id=first_event_id,
            started_id=EMPTY_EVENT_ID,
            started_workflow_id=event.get("workflow_id", ""),
            create_request_id=batch_request_id(event),
            domain_id=event.get("domain_id") or ms.execution_info.domain_id,
            workflow_type_name=event.get("workflow_type", ""),
            parent_close_policy=event.get("parent_close_policy", 0) or 0,
            task_list=event.get("task_list", "") or "",
        )
        ms.pending_child_execution_info_ids[ci.initiated_id] = ci
        return ci

    def _replicate_child_started(self, event: HistoryEvent) -> None:
        """Reference: mutable_state_builder.go:3485-3507."""
        ms = self.ms
        initiated_id = event.get("initiated_event_id")
        ci = ms.pending_child_execution_info_ids.get(initiated_id)
        if ci is None:
            raise ReplayError(f"missing child execution info {initiated_id}")
        ci.started_id = event.id
        ci.started_run_id = event.get("run_id", "")

    def _replicate_request_cancel_initiated(self, first_event_id: int,
                                            event: HistoryEvent) -> RequestCancelInfo:
        """Reference: mutable_state_builder.go:2760-2779."""
        ms = self.ms
        rci = RequestCancelInfo(
            version=event.version,
            initiated_event_batch_id=first_event_id,
            initiated_id=event.id,
            cancel_request_id=batch_request_id(event),
        )
        ms.pending_request_cancel_info_ids[rci.initiated_id] = rci
        return rci

    def _replicate_signal_external_initiated(self, first_event_id: int,
                                             event: HistoryEvent) -> SignalInfo:
        """Reference: mutable_state_builder.go:2883-2905."""
        ms = self.ms
        si = SignalInfo(
            version=event.version,
            initiated_event_batch_id=first_event_id,
            initiated_id=event.id,
            signal_request_id=batch_request_id(event),
            signal_name=event.get("signal_name", ""),
        )
        ms.pending_signal_info_ids[si.initiated_id] = si
        return si

    # -- search attributes / close --------------------------------------

    def _replicate_upsert_search_attributes(self, event: HistoryEvent) -> None:
        """Reference: mutable_state_builder.go:2926-2948."""
        upsert = event.get("search_attributes") or {}
        self.ms.execution_info.search_attributes.update(upsert)

    def _complete_workflow(self, first_event_id: int, event: HistoryEvent,
                           close_status: CloseStatus) -> None:
        """Common close-event handling + close tasks.

        Reference: mutable_state_builder.go:2561-2576 (completed), :2601-2616
        (failed), :2640-2655 (timed out), :2719-2733 (canceled), :3225-3240
        (terminated); task generation state_builder.go:517-585.
        """
        ms = self.ms
        ms.execution_info.update_workflow_state_close_status(
            WorkflowState.Completed, close_status
        )
        ms.execution_info.completion_event_batch_id = first_event_id
        ms.clear_stickyness()
        taskgen.generate_workflow_close_tasks(ms, event)

    def _replicate_continued_as_new(self, batch: HistoryBatch, first_event_id: int,
                                    event: HistoryEvent) -> None:
        """Reference: state_builder.go:587-627 + mutable_state_builder.go:3366-3382."""
        ms = self.ms
        if batch.new_run_events:
            new_run_id = event.get("new_execution_run_id", "")
            new_builder = StateBuilder(MutableState(ms.domain_entry))
            new_batch = HistoryBatch(
                domain_id=batch.domain_id,
                workflow_id=batch.workflow_id,
                run_id=new_run_id,
                events=batch.new_run_events,
                request_id=f"{batch.request_id}-new-run",
            )
            new_builder.apply_batch(new_batch)
            self.new_run_state = new_builder.ms
        ms.execution_info.update_workflow_state_close_status(
            WorkflowState.Completed, CloseStatus.ContinuedAsNew
        )
        ms.execution_info.completion_event_batch_id = first_event_id
        ms.clear_stickyness()
        taskgen.generate_workflow_close_tasks(ms, event)


def batch_request_id(event: HistoryEvent) -> str:
    """Replay creates fresh request IDs for initiated externals
    (state_builder.go:370-372,:436-438,:465); a deterministic derivation is
    used instead of uuid.New() so oracle and kernel agree."""
    return f"replay-req-{event.id}"
